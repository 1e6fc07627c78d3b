"""Heterogeneous matmul executor — the port of
``repro.core.hetero_matmul``: runs a :class:`KernelSchedule` numerically by
dispatching each partition to its dataflow-class kernel and merging the
partial outputs (paper §V-A: K-split partials are reduced at the end), and
runs many-kernel schedules through the same path
(:func:`execute_assignments`, :func:`execute_many_kernel_schedule`,
:func:`hetero_many_matmul`, :func:`execute_assignment_batches`).

``mesh=None`` (default) is the sequential path: one task after another on
the caller's stream. ``mesh=StreamMesh(n)`` switches to the stream executor
(``repro_torch.core.stream_exec``): each cluster's partitions run on its
own CUDA streams (:func:`cluster_submeshes`), concurrently, with
``pipeline_depth`` batches in flight, per-lane packed uploads
(``shard_operands``) and measured per-cluster timelines (``measure``,
``timeline_sink``); its results are the same bits as the sequential
path's. The JAX package's ``mesh_axis`` and ``interpret`` have no meaning
on one axis of streams and are left out.

Operands arrive dense (the host knows the true densities and prepares the
formats, the paper's §VI assumption). On the sequential path execution
stays on the device: slicing, format conversion, kernel dispatch and the
merge are torch ops on device tensors. The one host synchronisation is a
batched fetch of the per-partition capacity needs (launch shapes are fixed
per call), and those capacities are power-of-two bucketed as on the JAX
side.

Each layer of the sequential queue path opens a span of the port's tracer
(``repro_torch.obs``): ``repro.queue`` around :func:`hetero_many_matmul`,
``repro.sync`` around each host fetch, ``repro.schedule`` (in the
scheduler), ``repro.task`` around each task, ``repro.convert`` (in
``formats.ell``), ``repro.dispatch.<class>`` around each partition's
kernel call and ``repro.merge``. They record only with tracing on, and
are profiler ranges while a ``torch.profiler`` records; off, each site
costs a flag check.
"""
from __future__ import annotations

import contextvars
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.scheduler import (
    KernelSchedule,
    ManyKernelSchedule,
    schedule_many_kernels,
    schedule_single_kernel,
)
from repro_torch.core.workloads import Workload
from repro_torch.formats.ell import bucket_capacity, dense_to_ell
from repro_torch.formats.taxonomy import DataflowClass
from repro_torch.kernels import ops
from repro_torch.obs.trace import TRACE

#: Sequence numbers of this process's :func:`hetero_many_matmul` calls,
#: and the one running (the ``queue`` of its ``repro.task`` spans).
_QUEUES = itertools.count(1)
_QUEUE: contextvars.ContextVar = contextvars.ContextVar("repro_queue",
                                                        default=None)
_DISPATCH_SPANS = {c: f"repro.dispatch.{c.value}" for c in DataflowClass}


def _operand(x, device) -> torch.Tensor:
    """A dense operand on ``device``, float64 cast to float32 as
    ``jnp.asarray`` casts it without x64 (the kernels take float32 and
    bfloat16); every other dtype as it is."""
    t = torch.as_tensor(x, device=device)
    return t.float() if t.dtype == torch.float64 else t


def _compressed_operands(cls: DataflowClass, mirror: bool):
    """Which operands a class compresses, as ``(operand, major_axis)``
    pairs in REQUIRED_FORMATS order (operand is "a" or "b")."""
    if cls == DataflowClass.GEMM:
        return ()
    if cls == DataflowClass.SPMM:
        return (("a", 0),) if mirror else (("b", 1),)
    if cls == DataflowClass.SPGEMM_INNER:
        return (("a", 0), ("b", 1))
    if cls == DataflowClass.SPGEMM_OUTER:
        return (("a", 1), ("b", 0))
    if cls == DataflowClass.SPGEMM_GUSTAVSON:
        return (("a", 1), ("b", 1))
    raise ValueError(cls)


def _fiber_nnz_max(x: torch.Tensor, major_axis: int) -> torch.Tensor:
    """Device-side scalar: max nonzeros in any fiber along ``major_axis``."""
    return (x != 0).sum(dim=1 - major_axis).max()


def _prep_operands(cls: DataflowClass, a, b, mirror: bool, caps):
    """Device slices -> REQUIRED_FORMATS[cls] operands. ``caps`` are the
    bucketed capacities of the compressed operands, in
    :func:`_compressed_operands` order."""
    if cls == DataflowClass.GEMM:
        return a, b
    if cls == DataflowClass.SPMM:
        if mirror:
            return dense_to_ell(a, 0, caps[0]), b
        return a, dense_to_ell(b, 1, caps[0])
    if cls == DataflowClass.SPGEMM_INNER:
        return dense_to_ell(a, 0, caps[0]), dense_to_ell(b, 1, caps[1])
    if cls == DataflowClass.SPGEMM_OUTER:
        return dense_to_ell(a, 1, caps[0]), dense_to_ell(b, 0, caps[1])
    if cls == DataflowClass.SPGEMM_GUSTAVSON:
        return dense_to_ell(a, 1, caps[0]), dense_to_ell(b, 1, caps[1])
    raise ValueError(cls)


def _dispatch_partition(cls: DataflowClass, a, b, mirror: bool, block: int,
                        device):
    sized = dict(bm=block, bn=block, bk=block, device=device)
    with TRACE.span(_DISPATCH_SPANS[cls], cat="queue", mirror=mirror):
        if cls == DataflowClass.GEMM:
            return ops.gemm(a, b, **sized)
        if cls == DataflowClass.SPMM:
            if mirror:
                return ops.spmm_mirror(a, b, bm=block, bn=block,
                                       device=device)
            return ops.spmm(a, b, bm=block, bn=block, device=device)
        if cls == DataflowClass.SPGEMM_INNER:
            return ops.spgemm_inner(a, b, **sized)
        if cls == DataflowClass.SPGEMM_OUTER:
            return ops.spgemm_outer(a, b, **sized)
        if cls == DataflowClass.SPGEMM_GUSTAVSON:
            return ops.spgemm_gustavson(a, b, **sized)
    raise ValueError(cls)


def prepare_partitions(jobs):
    """Slice operands and derive bucketed capacities for a batch of jobs,
    with ONE host sync for every capacity in the batch.

    ``jobs`` is ``[(a_d, b_d, parts), ...]`` (device operands + non-empty
    partitions); returns, per job, ``[(partition, sa, sb, caps), ...]``.
    Every capacity comes from the TRUE fiber occupancy, and a cap below the
    measured need would silently drop nonzeros, so ``cap >= need`` is
    checked here, host-side, instead of a sync per conversion.
    """
    sliced, needs = [], []
    for a_d, b_d, parts in jobs:
        rows = []
        for p in parts:
            r = p.region
            sa = a_d[r.m0:r.m1, r.k0:r.k1]
            sb = b_d[r.k0:r.k1, r.n0:r.n1]
            refs = []
            for operand, ax in _compressed_operands(p.cls, p.mirror):
                x = sa if operand == "a" else sb
                refs.append((x, ax, len(needs)))
                needs.append(_fiber_nnz_max(x, ax))
            rows.append((p, sa, sb, refs))
        sliced.append(rows)
    # One host sync for every capacity in the batch.
    need_vals = _fetch(torch.stack(needs), "capacity") if needs else []

    prepared = []
    for rows in sliced:
        out_rows = []
        for p, sa, sb, refs in rows:
            caps = []
            for x, ax, i in refs:
                need = max(int(need_vals[i]), 1)
                cap = bucket_capacity(need, max_cap=x.shape[1 - ax])
                if cap < need:
                    raise ValueError(
                        f"partition {p.cls.value} (region {p.region}): "
                        f"bucketed capacity {cap} below measured fiber "
                        f"occupancy {need} — would silently drop nonzeros")
                caps.append(cap)
            out_rows.append((p, sa, sb, tuple(caps)))
        prepared.append(out_rows)
    return prepared


def _fetch(values: torch.Tensor, what: str) -> list:
    """``values.tolist()``: a host sync, in a ``repro.sync`` span."""
    with TRACE.span("repro.sync", cat="queue", what=what,
                    values=values.numel()):
        return values.tolist()


def _merge_partials(shape, dtype, device, rows) -> torch.Tensor:
    """Merge ``rows = [(region, partial), ...]`` (partition order) into a
    zero output: K-split partials for the same output tile sum first, then
    each tile lands with one add. The sequential and streamed executors
    both merge here, so they give the same bits."""
    tiles: dict = {}
    for r, q in rows:
        tiles.setdefault((r.m0, r.m1, r.n0, r.n1), []).append(q)
    with TRACE.span("repro.merge", cat="queue", tiles=len(tiles)):
        out = torch.zeros(shape, dtype=dtype, device=device)
        for (m0, m1, n0, n1), partials in tiles.items():
            acc = partials[0].to(dtype)
            for q in partials[1:]:
                acc = acc + q.to(dtype)
            out[m0:m1, n0:n1] += acc
        return out


def _mesh_device(device, mesh):
    """The device a call runs on: the mesh's when one is given (a
    ``device=`` beside it must name the same one), else ``device``."""
    if mesh is None:
        return ops.resolve_device(device)
    if device is not None:
        want = torch.device(device)
        if (want.type != mesh.device.type
                or want.index not in (None, mesh.device.index)):
            raise ValueError(f"device={device!r} but mesh= is on "
                             f"{mesh.device}")
    return mesh.device


def execute_schedule(a, b, schedule: KernelSchedule, block: int = 128,
                     device=None,
                     cost_sink: Optional[list] = None,
                     mesh=None, shard_operands: bool = True,
                     measure: bool = False,
                     timeline_sink: Optional[list] = None) -> torch.Tensor:
    """Run every partition on its assigned sub-accelerator kernel and merge.

    M/N-split partials tile the output; K-split partials for the same
    output tile sum first, then each tile lands with one add. ``a``/``b``
    are dense (numpy arrays or tensors; float64 becomes float32, as in the
    JAX package, and so for every executor below); ``device=None`` runs on
    the card and raises without one, ``device="cpu"`` runs the plain
    versions.

    ``mesh`` (a :class:`repro_torch.core.stream_exec.StreamMesh`) switches
    to the stream executor: each cluster's partitions run on its own lanes,
    concurrently, and merge into the same bits. ``shard_operands``,
    ``measure`` and ``timeline_sink`` are the stream executor's (see
    :func:`execute_assignments`); one schedule is one batch, so there is
    nothing to pipeline.

    ``cost_sink`` (optional list) is the achieved-intensity hook: one
    :class:`repro_torch.core.costmodel.SwKernelCost` (``ops.op_cost``) is
    appended per dispatched partition, the modelled FLOPs/bytes/time proxy
    of exactly the kernel call made. Off by default, because each entry
    reads the partition's true nonzero counts on the host; sequential path
    only (``mesh=None``).
    """
    if cost_sink is not None and mesh is not None:
        raise ValueError("cost_sink requires the sequential executor "
                         "(mesh=None)")
    if mesh is None and measure:
        raise ValueError("measure=True requires mesh= (a stream-executor "
                         "feature)")
    dev = _mesh_device(device, mesh)
    if mesh is not None:
        from repro_torch.core.stream_exec import execute_schedule_streamed

        return execute_schedule_streamed(
            a, b, schedule, mesh, block=block, shard_operands=shard_operands,
            measure=measure, timeline_sink=timeline_sink)
    a_d, b_d = _operand(a, dev), _operand(b, dev)
    m, n = a_d.shape[0], b_d.shape[1]
    parts = [p for p in schedule.partitions if not p.region.empty]

    rows = []
    for p, sa, sb, caps in prepare_partitions([(a_d, b_d, parts)])[0]:
        pa, pb = _prep_operands(p.cls, sa, sb, p.mirror, caps)
        if cost_sink is not None:
            cost_sink.append(ops.op_cost(p.cls, pa, pb, bm=block, bn=block,
                                         mirror=p.mirror))
        rows.append((p.region, _dispatch_partition(p.cls, pa, pb, p.mirror,
                                                   block, dev)))
    return _merge_partials((m, n), torch.promote_types(a_d.dtype, b_d.dtype),
                           dev, rows)


def hetero_matmul(a, b, config: cm.AcceleratorConfig, block: int = 128,
                  device=None):
    """Schedule + execute ``a @ b`` on a heterogeneous accelerator config.

    Returns ``(result, schedule)``; the schedule carries the analytical
    report. The densities are exact nonzero fractions (one host sync for
    both counts); the JAX package's float32 means can differ from them in
    the last bit.
    """
    dev = ops.resolve_device(device)
    a_d, b_d = _operand(a, dev), _operand(b, dev)
    m, k = a_d.shape
    k2, n = b_d.shape
    assert k == k2
    if a_d.numel() and b_d.numel():
        nz_a, nz_b = _fetch(torch.stack([torch.count_nonzero(a_d),
                                         torch.count_nonzero(b_d)]),
                            "density")
        d_mk, d_kn = nz_a / a_d.numel(), nz_b / b_d.numel()
    else:
        d_mk = d_kn = 0.0
    w = Workload("adhoc", "api", m, k, n, d_mk, d_kn)
    schedule = schedule_single_kernel(config, w)
    return execute_schedule(a_d, b_d, schedule, block=block,
                            device=dev), schedule


def _validated_jobs(assignments, operands_by_index):
    """Pair each assignment with its operands, checking shapes against the
    scheduled dims without copying the operands anywhere."""
    jobs = []
    for asg in assignments:
        idx = asg.task_index
        w = asg.workload
        if idx not in operands_by_index:
            raise ValueError(f"task {idx} ({w.name}): no operands supplied")
        a_d, b_d = operands_by_index[idx]
        if (tuple(np.shape(a_d)) != (w.m, w.k)
                or tuple(np.shape(b_d)) != (w.k, w.n)):
            raise ValueError(
                f"task {idx} ({w.name}): operands "
                f"{tuple(np.shape(a_d))}x{tuple(np.shape(b_d))} "
                f"don't match scheduled dims {(w.m, w.k)}x{(w.k, w.n)}")
        if not asg.placed:
            raise ValueError(
                f"task {idx} ({w.name}) has no placement timeline; "
                "build schedules via schedule_many_kernels")
        jobs.append((asg, a_d, b_d))
    return jobs


def execute_assignment_batches(
    batches,
    operands_by_index,
    config: cm.AcceleratorConfig,
    *,
    block: int = 128,
    mesh=None,
    pipeline_depth: int = 1,
    shard_operands: bool = True,
    measure: bool = False,
    timeline_sink: Optional[list] = None,
):
    """Run a STREAM of assignment batches through the stream executor's
    pipelined path: each batch's partitions go to their clusters' lanes, at
    most ``pipeline_depth`` batches in flight, so batch N+1's uploads and
    launches overlap batch N's work. ``measure=True`` stamps each cluster's
    lanes per batch and appends per-batch
    :class:`repro_torch.core.stream_exec.BatchTimeline` records to
    ``timeline_sink``. Requires ``mesh``; returns ``{task_index: output}``
    across all batches (task indices must be unique across the stream).
    """
    if mesh is None:
        raise ValueError(
            "execute_assignment_batches requires mesh= (the pipelined "
            "batch stream is a stream-executor feature; use "
            "execute_assignments for the sequential path)")
    from repro_torch.core.stream_exec import execute_job_batches_streamed

    job_batches, order = [], []
    for batch in batches:
        jobs = _validated_jobs(batch, operands_by_index)
        job_batches.append([
            (a_d, b_d, [pp.partition for pp in asg.placed
                        if not pp.partition.region.empty])
            for asg, a_d, b_d in jobs
        ])
        order.append([asg.task_index for asg, _, _ in jobs])
    outs_batches = execute_job_batches_streamed(
        job_batches, config, mesh, block=block,
        pipeline_depth=pipeline_depth, shard_operands=shard_operands,
        measure=measure, timeline_sink=timeline_sink)
    result = {}
    for idxs, outs in zip(order, outs_batches):
        for i, out in zip(idxs, outs):
            if i in result:
                raise ValueError(
                    f"task index {i} appears in more than one batch")
            result[i] = out
    return result


def execute_assignments(assignments, operands_by_index,
                        config: cm.AcceleratorConfig, block: int = 128,
                        device=None, mesh=None, pipeline_depth: int = 1,
                        shard_operands: bool = True, measure: bool = False,
                        timeline_sink: Optional[list] = None):
    """Numerically run a batch of :class:`TaskAssignment` placements.

    ``operands_by_index`` maps ``task_index`` -> dense ``(a, b)``; every
    assignment runs on its placed partitions (including multi-cluster
    splits with K-partial merging). Returns ``{task_index: output}``.
    ``device=None`` runs on the card and raises without one.

    ``mesh=None`` runs one task after another through
    :func:`execute_schedule`. ``mesh=StreamMesh(n)`` runs the whole batch
    on the stream executor: every cluster's partitions, across all
    assignments, on its own lanes, so assignments on different clusters
    run at the same time. ``shard_operands`` (stream executor only) selects
    per-lane packed uploads from the host (default) or the whole operands
    on the card. ``pipeline_depth > 1`` splits the batch into
    ``min(pipeline_depth, len(assignments))`` contiguous chunks and
    pipelines them; ``measure=True`` appends one measured
    :class:`~repro_torch.core.stream_exec.BatchTimeline` per chunk to
    ``timeline_sink``. The sequential path rejects ``pipeline_depth != 1``
    and ``measure=True``.
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if mesh is None and (pipeline_depth != 1 or measure):
        raise ValueError(
            "pipeline_depth > 1 and measure=True require mesh= (both are "
            "stream-executor features)")
    dev = _mesh_device(device, mesh)
    jobs = _validated_jobs(assignments, operands_by_index)

    if mesh is not None:
        if pipeline_depth > 1 and len(jobs) > 1:
            n_chunks = min(pipeline_depth, len(jobs))
            size, rem = divmod(len(jobs), n_chunks)
            batches, lo = [], 0
            for c in range(n_chunks):
                hi = lo + size + (1 if c < rem else 0)
                batches.append([asg for asg, _, _ in jobs[lo:hi]])
                lo = hi
        else:
            batches = [[asg for asg, _, _ in jobs]]
        return execute_assignment_batches(
            batches, operands_by_index, config, block=block, mesh=mesh,
            pipeline_depth=pipeline_depth, shard_operands=shard_operands,
            measure=measure, timeline_sink=timeline_sink)

    outs = {}
    queue = _QUEUE.get()
    for asg, a_d, b_d in jobs:
        with TRACE.span("repro.task", cat="queue", queue=queue,
                        task=asg.task_index, cls=asg.cls.value):
            parts = tuple(pp.partition for pp in asg.placed)
            ks = KernelSchedule(asg.workload, config, parts, asg.report)
            outs[asg.task_index] = execute_schedule(a_d, b_d, ks,
                                                    block=block, device=dev)
    return outs


def execute_many_kernel_schedule(
    operands: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    schedule: ManyKernelSchedule,
    block: int = 128,
    device=None,
    mesh=None,
    pipeline_depth: int = 1,
    shard_operands: bool = True,
    measure: bool = False,
    timeline_sink: Optional[list] = None,
) -> List[torch.Tensor]:
    """Numerically run a many-kernel (multi-tenant) schedule.

    ``operands[i]`` is the dense ``(a, b)`` pair of the i-th task of the
    queue given to :func:`schedule_many_kernels`; shapes must match that
    task's workload. Every assignment runs on its cluster's (class,
    orientation) pair, including per-partition dispatch and K-split merging
    for tasks the ``optimized`` policy split. ``mesh`` and the options
    after it route the queue through the stream executor, as in
    :func:`execute_assignments`; the outputs are the same bits as the
    sequential path's. Returns per-task outputs in queue order.
    """
    operands = list(operands)
    if len(operands) != len(schedule.assignments):
        raise ValueError(
            f"{len(operands)} operand pairs for "
            f"{len(schedule.assignments)} scheduled tasks")
    # Assignments are in priority order, not queue order: the task_index
    # mapping must be a full permutation or operands would silently pair
    # with the wrong (same-shaped) tasks.
    indices = sorted(a.task_index for a in schedule.assignments)
    if indices != list(range(len(operands))):
        raise ValueError(
            "schedule assignments lack a complete task_index permutation "
            f"(got {indices}); build schedules via schedule_many_kernels")
    outs = execute_assignments(
        schedule.assignments, dict(enumerate(operands)), schedule.config,
        block=block, device=device, mesh=mesh,
        pipeline_depth=pipeline_depth, shard_operands=shard_operands,
        measure=measure, timeline_sink=timeline_sink)
    return [outs[i] for i in range(len(operands))]


def hetero_many_matmul(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    config: cm.AcceleratorConfig,
    policy: str = "lpt",
    arrivals: Optional[Sequence[float]] = None,
    block: int = 128,
    device=None,
    mesh=None,
):
    """Schedule + execute a queue of matmuls on a heterogeneous accelerator.

    Builds one :class:`Workload` per ``(a, b)`` pair (true shapes and exact
    densities, one host sync for all of them), list-schedules the queue
    under ``policy``, and runs every assignment (on the stream executor
    with ``mesh``). Returns ``(outputs, schedule)``.
    """
    queue = next(_QUEUES)
    token = _QUEUE.set(queue)
    try:
        with TRACE.span("repro.queue", cat="queue", queue=queue,
                        tasks=len(pairs),
                        policy=getattr(policy, "name", policy)):
            dev = _mesh_device(device, mesh)
            dense = [(_operand(a, dev), _operand(b, dev)) for a, b in pairs]
            nnz = (_fetch(torch.stack([torch.count_nonzero(x)
                                       for ab in dense for x in ab]),
                          "density") if dense else [])
            tasks = []
            for i, (a, b) in enumerate(dense):
                m, k = a.shape
                k2, n = b.shape
                assert k == k2, (a.shape, b.shape)
                d_mk = nnz[2 * i] / a.numel() if a.numel() else 0.0
                d_kn = nnz[2 * i + 1] / b.numel() if b.numel() else 0.0
                tasks.append(Workload(f"task{i}", "api", m, k, n, d_mk,
                                      d_kn))
            ms = schedule_many_kernels(config, tasks, policy=policy,
                                       arrivals=arrivals)
            outs = execute_many_kernel_schedule(dense, ms, block=block,
                                                device=dev, mesh=mesh)
            return outs, ms
    finally:
        _QUEUE.reset(token)


def cluster_submeshes(n_model_devices: int, config: cm.AcceleratorConfig):
    """Map clusters onto contiguous slices of the mesh 'model' axis,
    proportional to PE share (on one card the axis is a
    :class:`~repro_torch.core.stream_exec.StreamMesh`'s lanes).

    Returns ``[(cluster_index, lo_device, hi_device), ...]`` covering
    ``range(n_model_devices)`` with every cluster owning at least one
    device — a proportional split is repaired so tiny-PE clusters never
    round to an empty span (an empty span would silently drop that
    cluster's partitions from a sharded run). When the axis has fewer
    devices than the config has clusters no such repair exists, and the
    mapping raises ``ValueError`` instead of emitting empty spans.
    """
    n_clusters = len(config.clusters)
    if n_model_devices < n_clusters:
        raise ValueError(
            f"cannot map {n_clusters} clusters onto {n_model_devices} "
            f"device(s): every cluster needs >= 1 device on the mesh "
            "'model' axis (shrink the config or grow the mesh)")
    total = sum(c.pes for c in config.clusters)
    spans = []
    lo = 0
    for i, c in enumerate(config.clusters):
        hi = lo + int(round(n_model_devices * c.pes / total))
        if i == n_clusters - 1:
            hi = n_model_devices
        # Repair the proportional split: at least one device per cluster,
        # while leaving room for every cluster still to come.
        hi = max(hi, lo + 1)
        hi = min(hi, n_model_devices - (n_clusters - 1 - i))
        spans.append((i, lo, hi))
        lo = hi
    return spans
