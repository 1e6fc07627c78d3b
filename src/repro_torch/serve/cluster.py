"""Multi-tenant serving runtime over the heterogeneous cluster — the port
of ``repro.serve.cluster``.

The paper's end goal is a datacenter accelerator serving a *stream* of
diverse tensor kernels (Fig 12/13: staggered arrivals, policy × design
co-DSE). This module is that online layer: a :class:`ClusterServer`
accepts tagged matmul requests (workload + tenant + arrival + optional
deadline), runs an event-driven admission/batching front-end over the
incremental :class:`~repro_torch.core.scheduler.OnlineScheduler` — batch
windows quantize admission, queue-depth back-pressure reads the engine's
live ``QueueStats`` — dispatches every admitted batch through the
scheduling-policy registry onto an
:class:`~repro_torch.core.costmodel.AcceleratorConfig`, and numerically
executes the placements on the card through the shared batch executor
(:func:`repro_torch.core.hetero_matmul.execute_assignments`), so each
response is checkable against the dense reference. With a
:class:`~repro_torch.core.stream_exec.StreamMesh` (``serve(mesh=...)``)
each admitted batch runs on the stream executor: every cluster's share of
the batch on its own CUDA streams, overlapping requests across clusters
the way the paper's concurrent clusters would, with ``pipeline_depth``
batches in flight and, under ``measure=True``, the measured per-cluster
timelines in the report.

Key invariant (tested): because admission only ever *delays* a request's
effective release time and the engine is the same event-stepped
list scheduler, the server's final placements equal
``schedule_many_kernels(config, tasks, policy, arrivals=admitted)`` run
offline — with a zero batch window and no depth gate, ``admitted`` is the
true arrival vector, so the server's p99 wait and per-cluster utilization
match the offline schedule exactly.

Traces are replayable JSON in (:func:`load_trace`/:func:`save_trace` — a
request list with dims, densities, tenants, arrivals, deadlines, operand
seeds) and JSON out (:func:`serve_result_to_json` — per-request timing +
the telemetry report), the same JSON as the JAX package's.
:func:`deploy_from_dse` turns a ``dse.co_search``/``dse.search`` result
into a running server.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.core.scheduler import (
    ManyKernelSchedule,
    OnlineScheduler,
    SchedulingPolicy,
    TaskAssignment,
    get_policy,
)
from repro_torch.core.workloads import Workload, synthesize
from repro_torch.obs import trace as _trace_mod

TRACE_VERSION = 1


# ---------------------------------------------------------------- requests
@dataclasses.dataclass(frozen=True)
class Request:
    """One tagged matmul request in the serving stream.

    ``arrival_cycles`` is when the tenant submitted it; an optional
    absolute ``deadline_cycles`` turns on SLA accounting; ``seed`` makes
    trace replay reproducible (operands are synthesised from it when the
    caller doesn't supply them); ``priority`` is the admission class read
    by the JAX package's fleet front-end (``ClusterServer`` itself is
    priority-agnostic)."""

    request_id: str
    tenant: str
    workload: Workload
    arrival_cycles: float
    deadline_cycles: Optional[float] = None
    seed: int = 0
    priority: int = 0

    def to_json(self) -> Dict:
        return {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "workload": {
                "name": self.workload.name,
                "application": self.workload.application,
                "m": self.workload.m,
                "k": self.workload.k,
                "n": self.workload.n,
                "d_mk": self.workload.d_mk,
                "d_kn": self.workload.d_kn,
            },
            "arrival_cycles": self.arrival_cycles,
            "deadline_cycles": self.deadline_cycles,
            "seed": self.seed,
            "priority": self.priority,
        }

    @staticmethod
    def from_json(d: Dict) -> "Request":
        w = d["workload"]
        dl = d.get("deadline_cycles")
        return Request(
            request_id=str(d["request_id"]),
            tenant=str(d["tenant"]),
            workload=Workload(w["name"], w.get("application", "serve"),
                              int(w["m"]), int(w["k"]), int(w["n"]),
                              float(w["d_mk"]), float(w["d_kn"])),
            arrival_cycles=float(d["arrival_cycles"]),
            deadline_cycles=None if dl is None else float(dl),
            seed=int(d.get("seed", 0)),
            priority=int(d.get("priority", 0)),
        )


def trace_to_json(requests: Sequence[Request]) -> Dict:
    return {"version": TRACE_VERSION,
            "requests": [r.to_json() for r in requests]}


def trace_from_json(d: Dict) -> List[Request]:
    if d.get("version", TRACE_VERSION) != TRACE_VERSION:
        raise ValueError(f"unsupported trace version {d.get('version')!r}")
    return [Request.from_json(r) for r in d["requests"]]


def save_trace(path, requests: Sequence[Request]) -> None:
    pathlib.Path(path).write_text(
        json.dumps(trace_to_json(requests), indent=2, sort_keys=True) + "\n")


def load_trace(path) -> List[Request]:
    return trace_from_json(json.loads(pathlib.Path(path).read_text()))


def generate_trace(
    n_requests: int,
    tenants: Sequence[str] = ("tenant_a", "tenant_b", "tenant_c"),
    seed: int = 0,
    mean_gap_cycles: float = 50_000.0,
    templates: Optional[Sequence[Workload]] = None,
    deadline_slack_cycles: Optional[float] = None,
) -> List[Request]:
    """Synthesise a reproducible multi-tenant request trace.

    Workloads cycle through ``templates`` (default: a small mixed-sparsity
    set whose dims are executable directly, no operand downscaling);
    arrival gaps are exponential with mean ``mean_gap_cycles``;
    ``deadline_slack_cycles`` (optional) stamps every request with
    ``arrival + slack`` as its SLA deadline."""
    import numpy as np

    if templates is None:
        templates = (
            Workload("dense_tile", "serve", 96, 96, 96, 1.0, 1.0),
            Workload("spmm_tile", "serve", 128, 128, 96, 1.0, 0.2),
            Workload("spgemm_tile", "serve", 128, 160, 96, 0.15, 0.2),
            Workload("tall_skinny", "serve", 256, 48, 64, 0.5, 0.3),
            Workload("hypersparse", "serve", 160, 160, 128, 0.02, 0.05),
        )
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        w = templates[int(rng.integers(len(templates)))]
        tenant = tenants[int(rng.integers(len(tenants)))]
        t += float(rng.exponential(mean_gap_cycles))
        deadline = (None if deadline_slack_cycles is None
                    else t + float(deadline_slack_cycles))
        reqs.append(Request(
            request_id=f"req{i:04d}", tenant=tenant, workload=w,
            arrival_cycles=t, deadline_cycles=deadline,
            seed=seed * 10_000 + i))
    return reqs


def request_operands(req: Request, max_elems: int = 1 << 22):
    """Dense ``(a, b)`` for a request, synthesised from its seed. The
    request's workload dims must be directly executable (``synthesize``
    must not have to downscale them) — the schedule is analytic on exactly
    those shapes."""
    a, b, (m, k, n) = synthesize(req.workload, seed=req.seed,
                                 max_elems=max_elems)
    if (m, k, n) != (req.workload.m, req.workload.k, req.workload.n):
        raise ValueError(
            f"request {req.request_id}: workload dims "
            f"{req.workload.dims} exceed the numeric operand budget "
            f"(synthesize downscaled to {(m, k, n)}); serve with "
            "execute=False or supply operands explicitly")
    return a, b


# ----------------------------------------------------------------- results
@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Outcome of one served request (placement + timing + output)."""

    request: Request
    assignment: TaskAssignment
    batch_id: int
    admitted_cycles: float           # effective release after admission
    output: Optional[object] = None  # torch.Tensor when executed

    @property
    def start_cycles(self) -> float:
        return min(pp.start_cycles for pp in self.assignment.placed)

    @property
    def finish_cycles(self) -> float:
        return self.assignment.finish_cycles

    @property
    def wait_cycles(self) -> float:
        """Queueing delay vs the TRUE arrival (includes admission delay)."""
        return self.start_cycles - self.request.arrival_cycles

    @property
    def turnaround_cycles(self) -> float:
        return self.finish_cycles - self.request.arrival_cycles

    @property
    def deadline_missed(self) -> bool:
        dl = self.request.deadline_cycles
        return dl is not None and self.finish_cycles > dl + 1e-9

    def to_json(self) -> Dict:
        clusters = sorted({pp.partition.cluster
                           for pp in self.assignment.placed})
        return {
            "request_id": self.request.request_id,
            "tenant": self.request.tenant,
            "batch_id": self.batch_id,
            "admitted_cycles": self.admitted_cycles,
            "start_cycles": self.start_cycles,
            "finish_cycles": self.finish_cycles,
            "wait_cycles": self.wait_cycles,
            "turnaround_cycles": self.turnaround_cycles,
            "clusters": clusters,
            "classes": sorted({pp.partition.cls.value
                               for pp in self.assignment.placed}),
            "split": self.assignment.split,
            "deadline_missed": self.deadline_missed,
        }


@dataclasses.dataclass(frozen=True)
class TenantStats:
    """Per-tenant service aggregates (the fairness input)."""

    tenant: str
    n_requests: int
    mean_wait_cycles: float
    p99_wait_cycles: float
    mean_turnaround_cycles: float
    deadline_misses: int

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServerReport:
    """Serving telemetry over a completed trace."""

    config_name: str
    policy: str
    n_requests: int
    n_batches: int
    makespan_cycles: float
    makespan_s: float
    throughput_rps: float            # requests / makespan second
    stats: cm.QueueStats             # waits vs TRUE arrivals + deadlines
    per_tenant: Tuple[TenantStats, ...]
    fairness_index: float            # Jain's index over tenant mean waits
    energy_pj: float
    total_bytes: float

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["stats"] = self.stats.to_json()
        d["per_tenant"] = [t.to_json() for t in self.per_tenant]
        return d


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Everything a serve run produced: per-request results (request
    order), the telemetry report, and the composed schedule (directly
    comparable to an offline ``schedule_many_kernels`` run)."""

    results: Tuple[RequestResult, ...]
    report: ServerReport
    schedule: ManyKernelSchedule
    #: Measured per-batch execution timelines
    #: (:class:`repro_torch.core.stream_exec.BatchTimeline`), present when
    #: the run executed on the stream executor; span-level detail only
    #: under ``measure=True``.
    timelines: Optional[Tuple] = None

    def export_chrome_trace(self, path) -> pathlib.Path:
        """Write this run's full timeline as Perfetto-loadable Chrome
        trace-event JSON: per-request arrival→admit→
        start→finish phase spans grouped by tenant, per-cluster
        placement rows, admission windows, a queue-depth counter track,
        and — when the run measured — the observed per-cluster windows.
        Built post-hoc from the recorded results, so it works whether or
        not live tracing was enabled during ``serve()``."""
        return _obs.write_chrome_trace(path, serve_trace_events(self))


def serve_result_to_json(sr: ServeResult) -> Dict:
    """Replayable JSON record of a serve run (trace out)."""
    d = {
        "version": TRACE_VERSION,
        "report": sr.report.to_json(),
        "results": [r.to_json() for r in sr.results],
    }
    if sr.timelines is not None:
        d["timelines"] = [tl.to_json() for tl in sr.timelines]
    return d


def serve_trace_events(sr: ServeResult) -> List[Dict]:
    """Build the Chrome trace events of a completed serve run
    (``Tracer`` internal form; string tids allowed — the exporter maps
    them to stable ints and names the rows after them).

    Virtual-timebase rows (modelled cycles → µs):

    * one row per request (grouped by tenant via the row name
      ``tenant/request_id``) carrying three back-to-back phase spans —
      ``admit`` (arrival → effective release after the batch window),
      ``queue`` (release → start) and ``run`` (start → finish) — whose
      total equals ``RequestResult.turnaround_cycles`` by construction;
    * one row per cluster with every placed partition span;
    * an ``admission`` row with one span per batch window plus a
      ``queue_depth`` counter track sampled at each arrival/start edge.

    Measured rows (``PID_MEASURED``, wall-clock relative to the driver
    origin) re-emit ``sr.timelines`` when present.
    """
    PV = _trace_mod.PID_VIRTUAL
    c2u = cm.cycles_to_us
    events: List[Dict] = []
    for res in sr.results:
        r = res.request
        tid = f"{r.tenant}/{r.request_id}"
        args = {
            "request_id": r.request_id,
            "tenant": r.tenant,
            "batch": res.batch_id,
            "clusters": sorted({pp.partition.cluster
                                for pp in res.assignment.placed}),
            "deadline_cycles": r.deadline_cycles,
            "deadline_missed": res.deadline_missed,
            "wait_cycles": res.wait_cycles,
            "turnaround_cycles": res.turnaround_cycles,
        }
        phases = (
            ("admit", r.arrival_cycles, res.admitted_cycles),
            ("queue", res.admitted_cycles, res.start_cycles),
            ("run", res.start_cycles, res.finish_cycles),
        )
        for name, t0, t1 in phases:
            events.append({
                "ph": "X", "name": name, "ts": c2u(t0),
                "dur": c2u(max(t1 - t0, 0.0)), "pid": PV, "tid": tid,
                "cat": "request", "args": args})
    clusters = sr.schedule.config.clusters
    for a in sr.schedule.assignments:
        for pp in a.placed:
            ci = pp.partition.cluster
            events.append({
                "ph": "X", "name": f"task{a.task_index}",
                "ts": c2u(pp.start_cycles), "dur": c2u(pp.cycles),
                "pid": PV, "tid": f"cluster{ci}:{clusters[ci].name}",
                "cat": "task",
                "args": {"task": a.task_index,
                         "cls": pp.partition.cls.value,
                         "mirror": pp.partition.mirror,
                         "split": a.split}})
    by_batch: Dict[int, List[RequestResult]] = {}
    for res in sr.results:
        by_batch.setdefault(res.batch_id, []).append(res)
    for bid in sorted(by_batch):
        rs = by_batch[bid]
        open_t = min(res.request.arrival_cycles for res in rs)
        admit = max(res.admitted_cycles for res in rs)
        events.append({
            "ph": "X", "name": f"window{bid}", "ts": c2u(open_t),
            "dur": c2u(max(admit - open_t, 0.0)), "pid": PV,
            "tid": "admission", "cat": "serve",
            "args": {"batch": bid, "n_requests": len(rs)}})
    edges = sorted(
        [(res.request.arrival_cycles, 1) for res in sr.results]
        + [(res.start_cycles, -1) for res in sr.results])
    depth = 0
    for t, d in edges:
        depth += d
        events.append({
            "ph": "C", "name": "queue_depth", "ts": c2u(t), "pid": PV,
            "tid": "admission", "args": {"queue_depth": float(depth)}})
    if sr.timelines:
        PM = _trace_mod.PID_MEASURED
        for tl in sr.timelines:
            events.append({
                "ph": "X", "name": f"batch{tl.batch_id}",
                "ts": tl.dispatch_s * 1e6, "dur": tl.elapsed_s * 1e6,
                "pid": PM, "tid": "batches", "cat": "batch",
                "args": {"batch": tl.batch_id, "n_jobs": tl.n_jobs}})
            for sp in tl.spans:
                events.append({
                    "ph": "X", "name": f"batch{tl.batch_id}",
                    "ts": sp.start_s * 1e6, "dur": sp.busy_s * 1e6,
                    "pid": PM,
                    "tid": (f"cluster{sp.cluster}"
                            f"[dev{sp.lo_device}:{sp.hi_device}]"),
                    "cat": "submesh",
                    "args": {"batch": tl.batch_id,
                             "cluster": sp.cluster}})
    return events


# Serving admission events on the virtual timebase; module-level and
# stubbable like the scheduler's hooks (see scheduler._trace_offer) so
# overhead baselines can null them out.
_MET_ADMITTED = _obs.METRICS.counter("serve.admitted")
_MET_BATCHES = _obs.METRICS.counter("serve.batches")
_MET_BACKPRESSURE = _obs.METRICS.counter("serve.backpressure_deferrals")


def _trace_admission(server: "ClusterServer", open_t: float, admit: float,
                     batch_id: int, n_requests: int) -> None:
    _MET_BATCHES.inc()
    _MET_ADMITTED.inc(n_requests)
    if not _trace_mod.ENABLED:
        return
    _trace_mod.TRACE.complete(
        f"window{batch_id}", cm.cycles_to_us(open_t),
        cm.cycles_to_us(max(admit - open_t, 0.0)),
        pid=_trace_mod.PID_VIRTUAL, tid="admission", cat="serve",
        batch=batch_id, n_requests=n_requests, policy=server.policy.name)


def _trace_backpressure(engine: OnlineScheduler, cap: int) -> None:
    _MET_BACKPRESSURE.inc()
    if not _trace_mod.ENABLED:
        return
    _trace_mod.TRACE.instant(
        "backpressure_defer", cm.cycles_to_us(engine.now),
        pid=_trace_mod.PID_VIRTUAL, tid="admission", cat="serve",
        queue_depth=engine.queue_depth, max_queue_depth=cap)


def _jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index over non-negative allocations; 1.0 = equal
    (including the all-zero 'nobody waited' case)."""
    if not xs:
        return 1.0
    total = sum(xs)
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return 1.0
    return (total * total) / (len(xs) * sq)


# ------------------------------------------------------------------ server
class ClusterServer:
    """Online request engine over a heterogeneous accelerator config.

    * ``batch_window_cycles`` — admission quantum: a window opens at the
      first unadmitted arrival; every request arriving within it joins
      the batch and is released to the scheduler at window close (0 =
      admit each arrival instant immediately).
    * ``max_queue_depth`` — back-pressure: while the engine's *live*
      ``QueueStats.queue_depth`` (offered-but-unstarted tasks) is at or
      above this, the next batch's admission is deferred to the following
      start/cluster-free event (best-effort: if no such event can reduce
      the depth, the batch is admitted anyway). ``None`` = no gate.

    Admission only ever delays effective release times, so the final
    schedule always equals the offline
    ``schedule_many_kernels(..., arrivals=admitted)``.
    """

    def __init__(self, config: cm.AcceleratorConfig,
                 policy: Union[str, SchedulingPolicy] = "optimized",
                 batch_window_cycles: float = 0.0,
                 max_queue_depth: Optional[int] = None):
        if batch_window_cycles < 0.0:
            raise ValueError(f"negative batch window: {batch_window_cycles}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1 or None, "
                             f"got {max_queue_depth}")
        self.config = config
        self.policy = (policy if isinstance(policy, SchedulingPolicy)
                       else get_policy(policy))
        self.batch_window_cycles = float(batch_window_cycles)
        self.max_queue_depth = max_queue_depth
        self._pending: List[Request] = []

    # -------------------------------------------------------- admission
    def submit(self, request: Request) -> None:
        """Enqueue one request for the next :meth:`serve` run."""
        self._pending.append(request)

    def extend(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.submit(r)

    @property
    def pending(self) -> Tuple[Request, ...]:
        return tuple(self._pending)

    def _defer_for_depth(self, engine: OnlineScheduler) -> None:
        """Hold admission while the live queue depth (the signal
        ``engine.live_stats()`` reports as ``QueueStats.queue_depth``) is
        at the cap, advancing the engine to the next depth-reducing
        event."""
        while engine.queue_depth >= self.max_queue_depth:
            _trace_backpressure(engine, self.max_queue_depth)
            cand = [a.start_cycles for a in engine.assignments
                    if a.start_cycles > engine.now]
            cand += [t for t in engine.ready if t > engine.now]
            if not cand:
                # No future start or release event exists, so no amount of
                # advancing can ever drain the queue below the cap —
                # admitting anyway would silently void the back-pressure
                # contract, and waiting would spin forever. Unreachable
                # from serve()'s own admission loop (admit times strictly
                # increase, so offered work always schedules a future
                # start); reachable when callers drive the engine
                # directly with future-dated offers.
                raise RuntimeError(
                    f"max_queue_depth={self.max_queue_depth} can never be "
                    f"satisfied: queue depth {engine.queue_depth} at "
                    f"t={engine.now} with no future start or release "
                    "event to drain it")
            engine.advance(until=min(cand))

    def serve(self, operands: Optional[Dict[str, Tuple]] = None,
              execute: bool = True,
              block: int = 128,
              max_elems: int = 1 << 22,
              mesh=None,
              pipeline_depth: int = 1,
              shard_operands: bool = True,
              measure: bool = False,
              device=None) -> ServeResult:
        """Replay every submitted request through admission, scheduling
        and (optionally) numerical execution; clears the queue.

        ``operands`` maps ``request_id`` -> dense ``(a, b)``; requests
        without an entry synthesise operands from their trace seed.
        ``execute=False`` runs telemetry-only (full-size Table-I style
        workloads schedule fine; only execution needs real arrays, and
        only execution needs the card). ``device=None`` executes on the
        card and raises without one; ``device="cpu"`` runs the kernels'
        plain versions.

        ``mesh`` (a :class:`~repro_torch.core.stream_exec.StreamMesh`)
        executes on the stream executor: each admitted batch's partitions
        go to their clusters' lanes, so requests placed on different
        clusters overlap, and batches dispatch in admission order. By
        default each batch's operands are packed per lane and uploaded from
        the host (``shard_operands=True``); ``shard_operands=False``
        uploads the whole operands and slices them on the card.
        ``pipeline_depth`` is the most batches in flight: depth 1 retires
        each batch before dispatching the next. ``measure=True`` (packed
        only) stamps every cluster's lanes per batch and reports the
        observed timelines through ``report.stats.measured_*`` /
        ``measured_spatial_speedup`` and ``ServeResult.timelines``.
        ``mesh=None`` (default) keeps the sequential executor and rejects
        ``pipeline_depth != 1`` / ``measure=True``.
        """
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if mesh is None and (pipeline_depth != 1 or measure):
            raise ValueError(
                "pipeline_depth > 1 and measure=True require mesh= "
                "(both are stream-executor features)")
        if measure and not shard_operands:
            raise ValueError(
                "measure=True requires shard_operands=True (the replicated "
                "program has no span-granular fences)")
        requests = sorted(self._pending,
                          key=lambda r: (r.arrival_cycles, r.request_id))
        self._pending = []
        ids = [r.request_id for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate request_id in trace")

        engine = OnlineScheduler(self.config, self.policy)
        admitted: Dict[int, Tuple[Request, float, int]] = {}
        i = 0
        batch_id = 0
        while i < len(requests):
            open_t = requests[i].arrival_cycles
            close_t = open_t + self.batch_window_cycles
            batch = [r for r in requests[i:] if r.arrival_cycles <= close_t]
            i += len(batch)
            admit = close_t if self.batch_window_cycles > 0.0 else open_t
            engine.advance(until=admit)
            if self.max_queue_depth is not None:
                self._defer_for_depth(engine)
            admit = max(admit, engine.now)
            for r in batch:
                idx = engine.offer(r.workload, arrival=admit)
                admitted[idx] = (r, admit, batch_id)
            _trace_admission(self, open_t, admit, batch_id, len(batch))
            batch_id += 1
        engine.drain()
        schedule = engine.finish()

        by_index = {a.task_index: a for a in schedule.assignments}
        outputs: Dict[int, object] = {}
        timelines: Optional[List] = None
        if execute and requests:
            from repro_torch.core.hetero_matmul import (
                _mesh_device,
                execute_assignment_batches,
                execute_assignments,
            )

            ops_by_index = {}
            for idx, (r, _, _) in admitted.items():
                if operands is not None and r.request_id in operands:
                    ops_by_index[idx] = operands[r.request_id]
                else:
                    ops_by_index[idx] = request_operands(r,
                                                         max_elems=max_elems)
            if mesh is None:
                outputs = execute_assignments(
                    schedule.assignments, ops_by_index, self.config,
                    block=block, device=device)
            else:
                # Stream executor: one batch per admitted batch, pipelined
                # in admission order (at most pipeline_depth in flight),
                # each cluster's share on its own lanes.
                _mesh_device(device, mesh)   # a device= must be the mesh's
                per_batch: Dict[int, List[TaskAssignment]] = {}
                for idx, (_, _, bid) in admitted.items():
                    per_batch.setdefault(bid, []).append(by_index[idx])
                timelines = []
                outputs = execute_assignment_batches(
                    [per_batch[bid] for bid in sorted(per_batch)],
                    ops_by_index, self.config, block=block, mesh=mesh,
                    pipeline_depth=pipeline_depth,
                    shard_operands=shard_operands,
                    measure=measure, timeline_sink=timelines)

        results = []
        for idx in sorted(admitted):
            r, admit, bid = admitted[idx]
            results.append(RequestResult(
                request=r, assignment=by_index[idx], batch_id=bid,
                admitted_cycles=admit, output=outputs.get(idx)))
        results.sort(key=lambda res: ids.index(res.request.request_id))
        report = self._report(results, schedule, batch_id,
                              timelines=timelines if measure else None)
        return ServeResult(tuple(results), report, schedule,
                           timelines=(tuple(timelines)
                                      if timelines is not None else None))

    def run_trace(self, requests: Sequence[Request], **kw) -> ServeResult:
        """Submit a whole trace and serve it."""
        self.extend(requests)
        return self.serve(**kw)

    # -------------------------------------------------------- telemetry
    def _report(self, results: Sequence[RequestResult],
                schedule: ManyKernelSchedule, n_batches: int,
                timelines: Optional[Sequence] = None) -> ServerReport:
        busy = list(schedule.stats.busy_cycles)  # one busy definition
        waits = [res.wait_cycles for res in results]
        turns = [res.turnaround_cycles for res in results]
        stats = cm.queue_stats(
            self.config, busy, waits, turns, schedule.makespan_cycles,
            finish_cycles=[res.finish_cycles for res in results],
            deadline_cycles=[res.request.deadline_cycles for res in results],
        )
        if timelines:
            # Measured twin of the modelled spatial pair: the observed
            # lane windows of the measure=True streamed run.
            from repro_torch.core.stream_exec import aggregate_timelines

            busy_s, makespan_s, sequential_s = aggregate_timelines(
                timelines, len(self.config.clusters))
            stats = dataclasses.replace(
                stats, measured_busy_s=busy_s,
                measured_makespan_s=makespan_s,
                measured_sequential_s=sequential_s)
        per_tenant: Dict[str, List[RequestResult]] = {}
        for res in results:
            per_tenant.setdefault(res.request.tenant, []).append(res)
        tenant_stats = []
        for tenant in sorted(per_tenant):
            rs = per_tenant[tenant]
            tw = [r.wait_cycles for r in rs]
            tenant_stats.append(TenantStats(
                tenant=tenant,
                n_requests=len(rs),
                mean_wait_cycles=sum(tw) / len(tw),
                p99_wait_cycles=cm.percentile(tw, 99.0),
                mean_turnaround_cycles=(
                    sum(r.turnaround_cycles for r in rs) / len(rs)),
                deadline_misses=sum(r.deadline_missed for r in rs),
            ))
        makespan_s = schedule.makespan_s
        return ServerReport(
            config_name=self.config.name,
            policy=self.policy.name,
            n_requests=len(results),
            n_batches=n_batches,
            makespan_cycles=schedule.makespan_cycles,
            makespan_s=makespan_s,
            throughput_rps=(len(results) / makespan_s
                            if makespan_s > 0 else 0.0),
            stats=stats,
            per_tenant=tuple(tenant_stats),
            fairness_index=_jain_index(
                [t.mean_wait_cycles for t in tenant_stats]),
            energy_pj=schedule.energy_pj,
            total_bytes=schedule.total_bytes,
        )


# ------------------------------------------------------------- DSE bridge
def deploy_from_dse(result, policy: Optional[str] = None,
                    hbm_bw: Optional[float] = None,
                    **server_kwargs) -> ClusterServer:
    """Build a :class:`ClusterServer` from a DSE result — the bridge from
    the design search's output to a running server.

    Accepts a ``dse.CoDseResult`` (uses its co-searched policy unless
    overridden), a ``dse.DseResult`` (policy defaults to ``optimized``),
    or a raw :class:`~repro_torch.core.costmodel.AcceleratorConfig`.
    ``hbm_bw`` optionally re-pins the memory system (co-DSE often sweeps
    at unlimited bandwidth; serving wants the real one)."""
    cfg = result if isinstance(result, cm.AcceleratorConfig) else result.config
    if policy is None:
        policy = getattr(result, "policy", None) or "optimized"
    if hbm_bw is not None:
        cfg = cm.AcceleratorConfig(cfg.name, cfg.clusters, hbm_bw)
    return ClusterServer(cfg, policy=policy, **server_kwargs)
