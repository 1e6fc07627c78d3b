"""Heterogeneous matmul executor — the port of
``repro.core.hetero_matmul``: runs a :class:`KernelSchedule` numerically by
dispatching each partition to its dataflow-class kernel and merging the
partial outputs (paper §V-A: K-split partials are reduced at the end), and
runs many-kernel schedules task by task through the same path
(:func:`execute_assignments`, :func:`execute_many_kernel_schedule`,
:func:`hetero_many_matmul`). Only the sequential path is ported: the JAX
package's sharded and pipelined options (``mesh``, ``pipeline_depth``,
``shard_operands``) wait for the stream executor (ROADMAP.md).

Operands arrive dense (the host knows the true densities and prepares the
formats, the paper's §VI assumption). Execution stays on the device:
slicing, format conversion, kernel dispatch and the merge are torch ops on
device tensors. The one host synchronisation is a batched fetch of the
per-partition capacity needs (launch shapes are fixed per call), and those
capacities are power-of-two bucketed as on the JAX side.
"""
from __future__ import annotations

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
    if cls == DataflowClass.GEMM:
        return ops.gemm(a, b, **sized)
    if cls == DataflowClass.SPMM:
        if mirror:
            return ops.spmm_mirror(a, b, bm=block, bn=block, device=device)
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
    need_vals = torch.stack(needs).tolist() if needs else []

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


def execute_schedule(a, b, schedule: KernelSchedule, block: int = 128,
                     device=None,
                     cost_sink: Optional[list] = None) -> torch.Tensor:
    """Run every partition on its assigned sub-accelerator kernel and merge.

    M/N-split partials tile the output; K-split partials for the same
    output tile sum first, then each tile lands with one add. ``a``/``b``
    are dense (numpy arrays or tensors; float64 becomes float32, as in the
    JAX package, and so for every executor below); ``device=None`` runs on
    the card and raises without one, ``device="cpu"`` runs the plain
    versions.

    ``cost_sink`` (optional list) is the achieved-intensity hook: one
    :class:`repro_torch.core.costmodel.SwKernelCost` (``ops.op_cost``) is
    appended per dispatched partition, the modelled FLOPs/bytes/time proxy
    of exactly the kernel call made. Off by default, because each entry
    reads the partition's true nonzero counts on the host.
    """
    dev = ops.resolve_device(device)
    a_d, b_d = _operand(a, dev), _operand(b, dev)
    m, n = a_d.shape[0], b_d.shape[1]
    out_dtype = torch.promote_types(a_d.dtype, b_d.dtype)
    parts = [p for p in schedule.partitions if not p.region.empty]

    tiles: dict = {}
    for p, sa, sb, caps in prepare_partitions([(a_d, b_d, parts)])[0]:
        pa, pb = _prep_operands(p.cls, sa, sb, p.mirror, caps)
        if cost_sink is not None:
            cost_sink.append(ops.op_cost(p.cls, pa, pb, bm=block, bn=block,
                                         mirror=p.mirror))
        partial = _dispatch_partition(p.cls, pa, pb, p.mirror, block, dev)
        r = p.region
        tiles.setdefault((r.m0, r.m1, r.n0, r.n1), []).append(partial)

    out = torch.zeros((m, n), dtype=out_dtype, device=dev)
    for (m0, m1, n0, n1), partials in tiles.items():
        acc = partials[0].to(out_dtype)
        for q in partials[1:]:
            acc = acc + q.to(out_dtype)
        out[m0:m1, n0:n1] += acc
    return out


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
        nz_a, nz_b = torch.stack([torch.count_nonzero(a_d),
                                  torch.count_nonzero(b_d)]).tolist()
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


def execute_assignments(assignments, operands_by_index,
                        config: cm.AcceleratorConfig, block: int = 128,
                        device=None):
    """Numerically run a batch of :class:`TaskAssignment` placements.

    ``operands_by_index`` maps ``task_index`` -> dense ``(a, b)``; every
    assignment runs through :func:`execute_schedule` on its placed
    partitions (including multi-cluster splits with K-partial merging),
    one task after another on one device. Returns ``{task_index:
    output}``. ``device=None`` runs on the card and raises without one.
    """
    dev = ops.resolve_device(device)
    outs = {}
    for asg, a_d, b_d in _validated_jobs(assignments, operands_by_index):
        parts = tuple(pp.partition for pp in asg.placed)
        ks = KernelSchedule(asg.workload, config, parts, asg.report)
        outs[asg.task_index] = execute_schedule(a_d, b_d, ks, block=block,
                                                device=dev)
    return outs


def execute_many_kernel_schedule(
    operands: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    schedule: ManyKernelSchedule,
    block: int = 128,
    device=None,
) -> List[torch.Tensor]:
    """Numerically run a many-kernel (multi-tenant) schedule.

    ``operands[i]`` is the dense ``(a, b)`` pair of the i-th task of the
    queue given to :func:`schedule_many_kernels`; shapes must match that
    task's workload. Every assignment runs on its cluster's (class,
    orientation) pair, including per-partition dispatch and K-split merging
    for tasks the ``optimized`` policy split. Returns per-task outputs in
    queue order.
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
    outs = execute_assignments(schedule.assignments, dict(enumerate(operands)),
                               schedule.config, block=block, device=device)
    return [outs[i] for i in range(len(operands))]


def hetero_many_matmul(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    config: cm.AcceleratorConfig,
    policy: str = "lpt",
    arrivals: Optional[Sequence[float]] = None,
    block: int = 128,
    device=None,
):
    """Schedule + execute a queue of matmuls on a heterogeneous accelerator.

    Builds one :class:`Workload` per ``(a, b)`` pair (true shapes and exact
    densities, one host sync for all of them), list-schedules the queue
    under ``policy``, and runs every assignment. Returns ``(outputs,
    schedule)``.
    """
    dev = ops.resolve_device(device)
    dense = [(_operand(a, dev), _operand(b, dev)) for a, b in pairs]
    nnz = (torch.stack([torch.count_nonzero(x) for ab in dense for x in ab])
           .tolist() if dense else [])
    tasks = []
    for i, (a, b) in enumerate(dense):
        m, k = a.shape
        k2, n = b.shape
        assert k == k2, (a.shape, b.shape)
        d_mk = nnz[2 * i] / a.numel() if a.numel() else 0.0
        d_kn = nnz[2 * i + 1] / b.numel() if b.numel() else 0.0
        tasks.append(Workload(f"task{i}", "api", m, k, n, d_mk, d_kn))
    ms = schedule_many_kernels(config, tasks, policy=policy,
                               arrivals=arrivals)
    outs = execute_many_kernel_schedule(dense, ms, block=block, device=dev)
    return outs, ms
