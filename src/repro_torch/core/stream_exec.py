"""Stream executor: each cluster's partitions on its own CUDA streams of one
card, the clusters running at the same time — the port of
``repro.core.sharded_exec``.

The paper's claim is *spatial* heterogeneity: AESPA's clusters are
independent blocks that run concurrently. The JAX package maps that onto
the "model" axis of a device mesh; on one H100 that axis becomes a set of
CUDA streams, the *lanes* of a :class:`StreamMesh`.
:func:`repro_torch.core.hetero_matmul.cluster_submeshes` gives every
cluster a contiguous range of lanes in proportion to its PE share (at
least one each), and partition ``i`` (in dispatch order, counted per
batch) of cluster ``c`` runs on lane ``lo_c + i mod (hi_c - lo_c)``
(:func:`device_for_partition`). Work on different lanes may overlap on
the card; work on one lane runs in order.

How a batch of jobs (``(a, b, partitions)`` triples) runs:

* **Operand placement (default, ``shard_operands=True``).** Operands stay
  on the host. Capacities are derived there (:func:`_host_capacities`, the
  host twin of ``prepare_partitions``, with the same strict cap >=
  measured-need check), so dispatch never waits on the card. Each lane's
  partition slices are packed into one pinned host buffer per dtype, copied
  with ``non_blocking=True`` on the lane's stream, and the lane then
  converts and dispatches its partitions under ``torch.cuda.stream(lane)``
  (every kernel wrapper launches on the current stream).
* **Replicated operands (``shard_operands=False``).** The whole operands
  are uploaded once on the caller's stream and sliced on the card, with
  ``prepare_partitions``' one host sync per batch; each lane waits on the
  upload before its work.
* **Merge.** Retire makes the caller's stream (the *merge stream*) wait on
  each lane's last event of the batch, then merges every job's partials in
  partition order exactly as the sequential ``execute_schedule`` does, so
  the result is the same bits. Partials made on a lane and read on the
  merge stream are marked with ``record_stream``, so the caching allocator
  does not hand their memory to a later batch before the merge has read
  it; the pinned buffers live until the batch retires.

**Pipelined batches** (:func:`execute_job_batches_streamed`): at most
``pipeline_depth`` batches in flight. Retiring a batch blocks the host on
its merge (an event on the merge stream), so batch N+1's host work and
launches overlap batch N's device work. ``pipeline_depth=1`` retires each
batch before dispatching the next.

**Measured timelines** (``measure=True``, which needs
``shard_operands=True`` as in the JAX package): each lane records a CUDA
event before and after its work in the batch, and each cluster's
:class:`SpanTiming` runs from the first start to the last end event over
its lanes that had work (a cluster without work gets an empty span at the
batch's dispatch time). Event times are taken against one origin event,
recorded on the merge stream and synchronised once per executor call, and
given in seconds on the call's origin; a batch's ``dispatch_s`` and
``done_s`` are the host clock (``perf_counter``) on the same origin. The
JAX package takes span ends from host fences instead.

``device="cpu"`` (tests only): the lanes run in turn with the same
mapping, and every stamp is the host clock.

Left out of the port: the JAX package's compiled-program cache and its
``executor.program_cache.*`` counters (the port compiles no programs; the
``nvcc`` build cache of ``kernels/_build.py`` plays that part), and
``interpret``/``mesh_axis`` (one axis of streams, no interpret mode). The
``executor.pipeline.in_flight`` gauge and the executor's trace spans are
ported.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.core.hetero_matmul import (
    _compressed_operands,
    _dispatch_partition,
    _merge_partials,
    _operand,
    _prep_operands,
    cluster_submeshes,
    prepare_partitions,
)
from repro_torch.core.scheduler import KernelSchedule
from repro_torch.formats.ell import bucket_capacity
from repro_torch.kernels import ops
from repro_torch.obs import trace as _trace_mod

#: Pack offsets are multiples of this many bytes, so every slice view
#: starts as aligned as a fresh allocation would.
_PACK_ALIGN_BYTES = 256

_MET_INFLIGHT = _obs.METRICS.gauge("executor.pipeline.in_flight")


class StreamMesh:
    """``n_lanes`` CUDA streams on one card: what the port's executors
    take as ``mesh=``. ``device=None`` means the card and raises when there
    is none; ``device="cpu"`` (tests) keeps the lane mapping and runs the
    lanes in turn."""

    def __init__(self, n_lanes: int, device=None):
        if int(n_lanes) < 1:
            raise ValueError(f"a StreamMesh needs >= 1 lane, got {n_lanes}")
        dev = ops.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.n_lanes = int(n_lanes)
        self.streams = (tuple(torch.cuda.Stream(dev) for _ in range(n_lanes))
                        if dev.type == "cuda" else (None,) * self.n_lanes)

    def lane(self, i: int):
        """Context in which torch ops and kernel launches go to lane
        ``i``."""
        s = self.streams[i]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())


def device_for_partition(spans, counters, cluster: int) -> int:
    """Lane assignment rule: partition ``i`` (in dispatch order) of
    cluster ``c`` runs on lane ``lo_c + (i mod (hi_c - lo_c))`` — the
    cluster's queue round-robins across its own contiguous span.
    ``counters`` is the mutable per-cluster dispatch counter."""
    _, lo, hi = spans[cluster]
    d = lo + counters.get(cluster, 0) % (hi - lo)
    counters[cluster] = counters.get(cluster, 0) + 1
    return d


class _Clock:
    """One executor call's origin. On the card: an event on the merge stream
    (the caller's current stream), synchronised once, against which lane
    events are read; on the CPU, the host clock alone."""

    def __init__(self, mesh: StreamMesh):
        self.cuda = mesh.device.type == "cuda"
        self.mesh = mesh
        if self.cuda:
            self.merge = torch.cuda.current_stream(mesh.device)
            self.origin_event = torch.cuda.Event(enable_timing=True)
            self.origin_event.record(self.merge)
            self.origin_event.synchronize()
        self.origin = time.perf_counter()

    def host_s(self) -> float:
        return time.perf_counter() - self.origin

    def mark(self, lane: int, timing: bool):
        """A stamp at this point of ``lane``'s stream."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(self.mesh.streams[lane])
        return ev

    def seconds(self, mark) -> float:
        """A stamp's time on the origin (its event must have completed)."""
        if not self.cuda:
            return mark - self.origin
        return self.origin_event.elapsed_time(mark) / 1e3

    def merge_wait(self, mark) -> None:
        if self.cuda:
            self.merge.wait_event(mark)

    def merge_mark(self) -> "torch.cuda.Event":
        """An event at this point of the merge stream (card only)."""
        ev = torch.cuda.Event()
        ev.record(self.merge)
        return ev

    def merge_done(self) -> None:
        """Block the host until the merge stream's work so far is done."""
        if self.cuda:
            self.merge_mark().synchronize()


# -------------------------------------------------- host-side operand prep
def _host_operand(x) -> torch.Tensor:
    """A dense operand as a host tensor: numpy arrays without a copy, card
    tensors copied back; float64 becomes float32 as in ``_operand``."""
    t = torch.as_tensor(x)
    if t.device.type != "cpu":
        t = t.cpu()
    return t.float() if t.dtype == torch.float64 else t


def _host_capacities(parts, a_h, b_h):
    """Host twin of :func:`repro_torch.core.hetero_matmul.prepare_partitions`
    for one job: slice the host operands and derive bucketed capacities from
    the TRUE fiber occupancy without touching the card (the pipelined
    dispatch must not wait behind batches in flight). Enforces the same
    strict cap >= measured-need contract on the exact slice values the
    card would see. Returns ``[(partition, sa, sb, caps), ...]`` with host
    tensor slices."""
    a_h, b_h = torch.as_tensor(a_h), torch.as_tensor(b_h)
    rows = []
    for p in parts:
        r = p.region
        sa = a_h[r.m0:r.m1, r.k0:r.k1]
        sb = b_h[r.k0:r.k1, r.n0:r.n1]
        caps = []
        for operand, ax in _compressed_operands(p.cls, p.mirror):
            x = sa if operand == "a" else sb
            need = (int((x != 0).sum(dim=1 - ax, dtype=torch.int32).max())
                    if x.numel() else 0)
            need = max(need, 1)
            cap = bucket_capacity(need, max_cap=x.shape[1 - ax])
            if cap < need:
                raise ValueError(
                    f"partition {p.cls.value} (region {p.region}): "
                    f"bucketed capacity {cap} below measured fiber "
                    f"occupancy {need} — would silently drop nonzeros")
            caps.append(cap)
        rows.append((p, sa, sb, tuple(caps)))
    return rows


def _assign_lanes(prepared, config: cm.AcceleratorConfig, spans, n_lanes):
    """Lane of every partition (:func:`device_for_partition`, counted per
    batch): ``per_lane[d] = [(job_idx, pos, partition, caps, sa, sb),
    ...]`` in dispatch order, ``pos`` the partition's place in its job."""
    known = {ci for ci, _, _ in spans}
    per_lane: List[List[Tuple]] = [[] for _ in range(n_lanes)]
    counters: dict = {}
    for job_idx, rows in enumerate(prepared):
        for pos, (p, sa, sb, caps) in enumerate(rows):
            if p.cluster not in known:
                raise ValueError(
                    f"partition on cluster {p.cluster} but config "
                    f"{config.name!r} has {len(config.clusters)} clusters")
            d = device_for_partition(spans, counters, p.cluster)
            per_lane[d].append((job_idx, pos, p, caps, sa, sb))
    return per_lane


def _pack(entries, pinned: bool):
    """Pack one lane's host slices into one host buffer per dtype (pinned
    for the card), each slice at an aligned offset. Returns the buffers
    and each slice's ``(dtype, offset, shape)``, in ``entries`` order."""
    layout, widths = [], {}
    for *_, sa, sb in entries:
        for x in (sa, sb):
            align = max(_PACK_ALIGN_BYTES // x.element_size(), 1)
            off = -(-widths.get(x.dtype, 0) // align) * align
            widths[x.dtype] = off + x.numel()
            layout.append((x, off))
    host = {dt: torch.empty(n, dtype=dt, pin_memory=pinned)
            for dt, n in widths.items()}
    for x, off in layout:
        host[x.dtype][off:off + x.numel()].view(x.shape).copy_(x)
    return host, [(x.dtype, off, x.shape) for x, off in layout]


def _upload(host, layout, device: torch.device):
    """Copy packed buffers to ``device`` on the current stream without
    blocking the host; returns each partition's ``(sa, sb)`` as views of
    the copies."""
    on_dev = {dt: buf.to(device, non_blocking=True)
              for dt, buf in host.items()}
    views = [on_dev[dt][off:off + shape.numel()].view(shape)
             for dt, off, shape in layout]
    return list(zip(views[0::2], views[1::2]))


# --------------------------------------------------- measured timelines
@dataclasses.dataclass(frozen=True)
class SpanTiming:
    """Measured window of one cluster's lane span for one batch:
    ``lo_device``/``hi_device`` are the span's lanes (the JAX package's
    field names, so both give the same JSON); ``start_s``/``end_s`` the
    first start and last end event over the span's lanes with work.
    Seconds, relative to the executor call's origin."""

    cluster: int
    lo_device: int
    hi_device: int
    start_s: float
    end_s: float

    @property
    def busy_s(self) -> float:
        return max(self.end_s - self.start_s, 0.0)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["busy_s"] = self.busy_s
        return d


@dataclasses.dataclass(frozen=True)
class BatchTimeline:
    """Per-batch measured timeline: dispatch/done host timestamps plus one
    :class:`SpanTiming` per cluster span (``measure=True`` runs only —
    unmeasured runs still record dispatch/done)."""

    batch_id: int
    n_jobs: int
    dispatch_s: float
    done_s: float
    spans: Tuple[SpanTiming, ...] = ()

    @property
    def elapsed_s(self) -> float:
        return max(self.done_s - self.dispatch_s, 0.0)

    def to_json(self) -> Dict:
        return {
            "batch_id": self.batch_id,
            "n_jobs": self.n_jobs,
            "dispatch_s": self.dispatch_s,
            "done_s": self.done_s,
            "elapsed_s": self.elapsed_s,
            "spans": [s.to_json() for s in self.spans],
        }


def trace_batch_timeline(tl: BatchTimeline, origin: float) -> None:
    """Re-emit one retired batch's measured timeline onto the process
    tracer's MEASURED rows: the batch's dispatch→done window on a
    per-pipeline row and each :class:`SpanTiming` as a span on its
    cluster's row. ``origin`` is the executor call's absolute ``perf_counter``
    epoch (timeline stamps are relative to it); the tracer maps both onto
    its own epoch so measured rows line up with the host spans.
    No-op while tracing is disabled."""
    if not _trace_mod.ENABLED:
        return
    tr = _trace_mod.TRACE
    ts0 = tr.ts_from_perf(origin + tl.dispatch_s)
    tr.complete(f"batch{tl.batch_id}", ts0,
                max(tl.done_s - tl.dispatch_s, 0.0) * 1e6,
                pid=_trace_mod.PID_MEASURED, tid="batches", cat="batch",
                batch=tl.batch_id, n_jobs=tl.n_jobs)
    for sp in tl.spans:
        tr.complete(
            f"batch{tl.batch_id}", tr.ts_from_perf(origin + sp.start_s),
            sp.busy_s * 1e6, pid=_trace_mod.PID_MEASURED,
            tid=f"cluster{sp.cluster}[dev{sp.lo_device}:{sp.hi_device}]",
            cat="submesh", batch=tl.batch_id, cluster=sp.cluster)


def aggregate_timelines(timelines: Sequence[BatchTimeline],
                        n_clusters: int
                        ) -> Tuple[Tuple[float, ...], float, float]:
    """Fold measured batch timelines into the ``QueueStats.measured_*``
    triple: per-cluster busy seconds (Σ span windows), wall makespan
    (first dispatch → last done) and sequential seconds (Σ busy) — the
    observed twin of the modelled concurrent/sequential makespan pair."""
    busy = [0.0] * n_clusters
    for tl in timelines:
        for sp in tl.spans:
            if 0 <= sp.cluster < n_clusters:
                busy[sp.cluster] += sp.busy_s
    if timelines:
        makespan = (max(tl.done_s for tl in timelines)
                    - min(tl.dispatch_s for tl in timelines))
    else:
        makespan = 0.0
    return tuple(busy), max(makespan, 0.0), sum(busy)


# ----------------------------------------------------- dispatch and retire
class _InFlight:
    """One dispatched batch awaiting retirement."""

    __slots__ = ("batch_id", "n_jobs", "out_meta", "partials", "marks",
                 "spans", "dispatch_s", "keep")

    def __init__(self, batch_id, n_jobs, out_meta, partials, marks, spans,
                 dispatch_s, keep):
        self.batch_id = batch_id
        self.n_jobs = n_jobs
        self.out_meta = out_meta    # per job: ((m, n), out dtype)
        self.partials = partials    # per job: {pos: (region, partial)}
        self.marks = marks          # lane -> (start mark, end mark)
        self.spans = spans
        self.dispatch_s = dispatch_s
        self.keep = keep            # host buffers and operands in use


def _dispatch_batch(batch_id, jobs, config, mesh: StreamMesh, block,
                    shard_operands, measure, clock: _Clock):
    """Enqueue one batch on the lanes; returns without waiting for the card
    (the replicated mode waits once, for its capacities)."""
    dev = mesh.device
    if not jobs:
        return _InFlight(batch_id, 0, [], [], {}, (), clock.host_s(), ())
    spans = tuple(cluster_submeshes(mesh.n_lanes, config))
    keep = []
    if shard_operands:
        hosts = [(_host_operand(a), _host_operand(b), parts)
                 for a, b, parts in jobs]
        prepared = [_host_capacities(parts, a, b) for a, b, parts in hosts]
        ready = None
    else:
        # Replicated: whole operands on the card (on the merge stream),
        # capacities by the shared device pass (one host sync).
        hosts = [(_operand(a, dev), _operand(b, dev), parts)
                 for a, b, parts in jobs]
        prepared = prepare_partitions([(a, b, list(parts))
                                       for a, b, parts in hosts])
        ready = clock.merge_mark() if clock.cuda else None
        keep.extend(t for a, b, _ in hosts for t in (a, b))
    out_meta = [((a.shape[0], b.shape[1]),
                 torch.promote_types(a.dtype, b.dtype))
                for a, b, _ in hosts]
    per_lane = _assign_lanes(prepared, config, spans, mesh.n_lanes)
    # Every lane's host packing first, then every lane's upload, then the
    # launches in dispatch order, each on its lane: the work goes out in
    # one burst and the lanes can overlap on the card.
    packed = {d: _pack(entries, pinned=clock.cuda)
              for d, entries in enumerate(per_lane)
              if entries and shard_operands}
    keep.extend(host for host, _ in packed.values())
    dispatch_s = clock.host_s()
    slices, starts = {}, {}
    for d, entries in enumerate(per_lane):
        if not entries:
            continue
        with mesh.lane(d):
            if ready is not None:
                mesh.streams[d].wait_event(ready)
                for t in keep:
                    t.record_stream(mesh.streams[d])
            starts[d] = clock.mark(d, measure)
            slices[d] = (_upload(*packed[d], dev) if shard_operands
                         else [(sa, sb) for *_, sa, sb in entries])
    launches = sorted(((d, e, ab) for d in slices
                       for e, ab in zip(per_lane[d], slices[d])),
                      key=lambda t: t[1][:2])
    partials: List[Dict] = [{} for _ in jobs]
    left = {d: len(ab) for d, ab in slices.items()}
    marks = {}
    for d, (job_idx, pos, p, caps, _, _), (sa, sb) in launches:
        with mesh.lane(d):
            pa, pb = _prep_operands(p.cls, sa, sb, p.mirror, caps)
            partials[job_idx][pos] = (
                p.region,
                _dispatch_partition(p.cls, pa, pb, p.mirror, block, dev))
            left[d] -= 1
            if not left[d]:   # the lane's last launch of the batch
                marks[d] = (starts[d], clock.mark(d, measure))
    return _InFlight(batch_id, len(jobs), out_meta, partials, marks, spans,
                     dispatch_s, keep)


def _retire_batch(handle: _InFlight, measure: bool, clock: _Clock,
                  device: torch.device) -> Tuple[List, BatchTimeline]:
    """Merge a dispatched batch on the merge stream once every lane's work
    is done, block the host until the merge is, and (measured) read each
    cluster span's window from its lanes' events."""
    if handle.n_jobs == 0:
        return [], BatchTimeline(handle.batch_id, 0, handle.dispatch_s,
                                 clock.host_s())
    for _, end in handle.marks.values():
        clock.merge_wait(end)
    outs = []
    for (shape, dtype), parts in zip(handle.out_meta, handle.partials):
        rows = [parts[pos] for pos in sorted(parts)]
        if clock.cuda:
            for _, q in rows:
                q.record_stream(clock.merge)
        outs.append(_merge_partials(shape, dtype, device, rows))
    clock.merge_done()
    done_s = clock.host_s()
    span_timings: Tuple[SpanTiming, ...] = ()
    if measure:
        stamps = []
        for ci, lo, hi in handle.spans:
            lanes = [handle.marks[d] for d in range(lo, hi)
                     if d in handle.marks]
            if lanes:
                start = min(clock.seconds(s) for s, _ in lanes)
                end = max(clock.seconds(e) for _, e in lanes)
            else:
                start = end = handle.dispatch_s
            stamps.append(SpanTiming(ci, lo, hi, start, end))
        span_timings = tuple(stamps)
    handle.partials = handle.keep = None
    return outs, BatchTimeline(handle.batch_id, handle.n_jobs,
                               handle.dispatch_s, done_s, span_timings)


# ------------------------------------------------------------- public API
def execute_job_batches_streamed(
    batches: Sequence[Sequence[Tuple]],
    config: cm.AcceleratorConfig,
    mesh: StreamMesh,
    block: int = 128,
    pipeline_depth: int = 1,
    shard_operands: bool = True,
    measure: bool = False,
    timeline_sink: Optional[list] = None,
) -> List[List[torch.Tensor]]:
    """Run a stream of job batches — each a sequence of ``(a, b,
    partitions)`` triples — on the lanes of ``mesh``, at most
    ``pipeline_depth`` batches in flight.

    ``pipeline_depth=1`` retires every batch before dispatching the next;
    deeper pipelines overlap batch N+1's host packing, uploads and launches
    with batch N's device work. ``shard_operands`` selects per-lane packed
    uploads from the host (default) or the whole operands on the card.
    ``measure=True`` (packed mode only) stamps each lane's work per batch
    and appends one :class:`BatchTimeline` with a :class:`SpanTiming` per
    cluster to ``timeline_sink``; unmeasured runs append dispatch/done-only
    timelines when a sink is given.

    Returns per-batch output lists (job order within each batch), on the
    caller's current stream.
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if measure and not shard_operands:
        raise ValueError("measure=True requires shard_operands=True (the "
                         "replicated program has no span-granular fences)")
    batches = list(batches)
    results: List[Optional[List]] = [None] * len(batches)
    clock = _Clock(mesh)
    inflight: "collections.deque" = collections.deque()
    tr = _trace_mod.TRACE

    def sample_inflight():
        _MET_INFLIGHT.set(len(inflight))
        if _trace_mod.ENABLED:
            tr.counter("in_flight", float(len(inflight)),
                       pid=_trace_mod.PID_HOST, tid="pipeline")

    def retire_one():
        bi, handle = inflight.popleft()
        with tr.span("retire", pid=_trace_mod.PID_HOST, tid="pipeline",
                     cat="executor", batch=bi, n_jobs=handle.n_jobs):
            outs, tl = _retire_batch(handle, measure, clock, mesh.device)
        results[bi] = outs
        trace_batch_timeline(tl, clock.origin)
        sample_inflight()
        if timeline_sink is not None:
            timeline_sink.append(tl)

    for bi, jobs in enumerate(batches):
        while len(inflight) >= pipeline_depth:
            retire_one()
        jobs = list(jobs)
        with tr.span("dispatch", pid=_trace_mod.PID_HOST, tid="pipeline",
                     cat="executor", batch=bi, n_jobs=len(jobs)):
            handle = _dispatch_batch(bi, jobs, config, mesh, block,
                                     shard_operands, measure, clock)
        inflight.append((bi, handle))
        sample_inflight()
    while inflight:
        retire_one()
    return results  # type: ignore[return-value]


def execute_jobs_streamed(
    jobs: Sequence[Tuple],
    config: cm.AcceleratorConfig,
    mesh: StreamMesh,
    block: int = 128,
    shard_operands: bool = True,
    measure: bool = False,
    timeline_sink: Optional[list] = None,
) -> List[torch.Tensor]:
    """Run a batch of jobs — ``(a, b, partitions)`` triples — as one batch
    on the lanes of ``mesh``, each cluster's partition queue on its own
    lanes, concurrently. Returns per-job outputs, in job order."""
    if not jobs:
        return []
    return execute_job_batches_streamed(
        [jobs], config, mesh, block=block, pipeline_depth=1,
        shard_operands=shard_operands, measure=measure,
        timeline_sink=timeline_sink)[0]


def execute_schedule_streamed(a, b, schedule: KernelSchedule,
                              mesh: StreamMesh, block: int = 128,
                              shard_operands: bool = True,
                              measure: bool = False,
                              timeline_sink: Optional[list] = None
                              ) -> torch.Tensor:
    """Streamed single-kernel entry: one :class:`KernelSchedule`'s
    partitions across the cluster lanes of ``mesh``, merged. The same bits
    as ``execute_schedule(a, b, schedule)``."""
    parts = [p for p in schedule.partitions if not p.region.empty]
    return execute_jobs_streamed([(a, b, parts)], schedule.config, mesh,
                                 block=block, shard_operands=shard_operands,
                                 measure=measure,
                                 timeline_sink=timeline_sink)[0]
