"""Scheduling for heterogeneous sparse accelerators (paper §V), copied
from ``repro.core.scheduler`` so the port carries no dependency on the JAX
package.

:func:`schedule_single_kernel` partitions ONE matmul across M/N/K into
regions of different compression formats, one per sub-accelerator cluster,
to maximise TFLOP/s on a latency-critical kernel (Fig 6). The schedule it
returns feeds both the analytical cost model and the numerical executor
(``repro_torch.core.hetero_matmul.execute_schedule``).
:func:`batch_single_kernel_eval` runs the same search for a whole batch of
candidate designs in one numpy pass, the DSE's evaluator
(``repro_torch.core.dse``).

:func:`schedule_many_kernels` list-schedules a queue of independent kernels
onto the clusters under a registered policy (``lpt``, ``sjf``,
``affinity``, ``optimized``; paper §V-B, Fig 12) through the event-stepped
:class:`OnlineScheduler`, whose offer, dispatch and defer events and
``scheduler.*`` counters go to the port's own ``repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.core import hwdb
from repro_torch.core.workloads import Workload
from repro_torch.formats.taxonomy import DataflowClass
from repro_torch.obs import trace as _trace_mod


@dataclasses.dataclass(frozen=True)
class Region:
    """Half-open index ranges of a partition within the M×K×N iteration
    space."""

    m0: int
    m1: int
    k0: int
    k1: int
    n0: int
    n1: int

    @property
    def m(self) -> int:
        return self.m1 - self.m0

    @property
    def k(self) -> int:
        return self.k1 - self.k0

    @property
    def n(self) -> int:
        return self.n1 - self.n0

    @property
    def empty(self) -> bool:
        return self.m <= 0 or self.k <= 0 or self.n <= 0


@dataclasses.dataclass(frozen=True)
class Partition:
    region: Region
    cls: DataflowClass
    cluster: int              # index into config.clusters
    mirror: bool = False      # SpMM orientation (A-compressed when True)


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    workload: Workload
    config: cm.AcceleratorConfig
    partitions: Tuple[Partition, ...]
    report: cm.KernelReport

    @property
    def k_split(self) -> bool:
        ks = {(p.region.k0, p.region.k1) for p in self.partitions}
        return len(ks) > 1


def _evaluate(config: cm.AcceleratorConfig, w: Workload,
              partitions: Sequence[Partition]) -> cm.KernelReport:
    per_cluster: Dict[int, float] = {}
    costs = []
    for p in partitions:
        r = p.region
        if r.empty:
            continue
        c = cm.partition_cost(
            p.cls, config.clusters[p.cluster], r.m, r.k, r.n,
            w.d_mk, w.d_kn, mirror=p.mirror,
            scratch_bytes=config.scratchpad_bytes,
        )
        costs.append(c)
        per_cluster[p.cluster] = per_cluster.get(p.cluster, 0.0) + c.cycles
    return cm.aggregate(config, per_cluster, costs)


def _whole_kernel_candidates(config: cm.AcceleratorConfig, w: Workload
                             ) -> List[Tuple[Partition, ...]]:
    """Whole kernel on a single cluster, each supported class/orientation."""
    whole = Region(0, w.m, 0, w.k, 0, w.n)
    cands = []
    for ci, cluster in enumerate(config.clusters):
        for cls in cluster.supported:
            if cls == DataflowClass.SPMM:
                cands.append((Partition(whole, cls, ci, mirror=False),))
                cands.append((Partition(whole, cls, ci, mirror=True),))
            else:
                cands.append((Partition(whole, cls, ci),))
    return cands


def _template_partitions(config: cm.AcceleratorConfig, w: Workload,
                         fm: float, fk: float, fn: float
                         ) -> Optional[Tuple[Partition, ...]]:
    """The Fig 6e composite template: M×N×K split feeding every cluster.

    (M0,K0,N0)->GEMM; (M1,K0,N0)->SpMM(A-comp); (M0,K0,N1)->SpMM(B-comp);
    (M1,K0,N1)->inner SpGEMM; (:,K1,:) -> K-bound classes (outer/Gustavson),
    K1 further split along N between them proportional to usable PEs.
    """
    gemm_cl = config.clusters_supporting(DataflowClass.GEMM)
    spmm_cl = config.clusters_supporting(DataflowClass.SPMM)
    inner_cl = config.clusters_supporting(DataflowClass.SPGEMM_INNER)
    outer_cl = config.clusters_supporting(DataflowClass.SPGEMM_OUTER)
    gust_cl = config.clusters_supporting(DataflowClass.SPGEMM_GUSTAVSON)

    m_s = int(round(w.m * fm))
    k_s = int(round(w.k * fk))
    n_s = int(round(w.n * fn))
    parts: List[Partition] = []

    def add(region: Region, cls: DataflowClass, cluster_ids, mirror=False):
        if region.empty or not cluster_ids:
            return region.empty
        parts.append(Partition(region, cls, cluster_ids[0], mirror))
        return True

    ok = True
    # K0 block, 2-D M/N quadrants.
    ok &= add(Region(0, m_s, 0, k_s, 0, n_s), DataflowClass.GEMM, gemm_cl)
    ok &= add(Region(m_s, w.m, 0, k_s, 0, n_s), DataflowClass.SPMM, spmm_cl,
              mirror=True)
    ok &= add(Region(0, m_s, 0, k_s, n_s, w.n), DataflowClass.SPMM, spmm_cl)
    ok &= add(Region(m_s, w.m, 0, k_s, n_s, w.n), DataflowClass.SPGEMM_INNER,
              inner_cl)
    # K1 block: K-parallel classes; split N proportional to usable PEs.
    if k_s < w.k:
        k1 = w.k - k_s
        po = (min(config.clusters[outer_cl[0]].pes, k1) if outer_cl else 0)
        pg = (min(config.clusters[gust_cl[0]].pes, w.n) if gust_cl else 0)
        if po + pg == 0:
            ok = False
        else:
            n_mid = int(round(w.n * po / (po + pg)))
            ok &= add(Region(0, w.m, k_s, w.k, 0, n_mid),
                      DataflowClass.SPGEMM_OUTER, outer_cl)
            ok &= add(Region(0, w.m, k_s, w.k, n_mid, w.n),
                      DataflowClass.SPGEMM_GUSTAVSON, gust_cl)
    if not ok or not parts:
        return None
    return tuple(parts)


_FRACS = (0.0, 0.25, 0.5, 0.75, 1.0)
_FRACS_FINE = tuple(i / 8 for i in range(9))


# ------------------------------------------------ batched template search
def _np_tripcount(cls: DataflowClass, mf, kf, nf, d_mk: float, d_kn: float,
                  mirror: bool):
    if cls == DataflowClass.GEMM:
        return mf * kf * nf
    if cls == DataflowClass.SPMM:
        return mf * kf * nf * (d_mk if mirror else d_kn)
    return mf * kf * nf * d_mk * d_kn


def _np_parallelism_bound(cls: DataflowClass, mf, kf, nf, mirror: bool):
    if cls == DataflowClass.GEMM:
        return mf * nf
    if cls == DataflowClass.SPMM:
        return mf if mirror else nf
    if cls == DataflowClass.SPGEMM_INNER:
        return np.maximum(mf, nf)
    if cls == DataflowClass.SPGEMM_OUTER:
        return kf
    if cls == DataflowClass.SPGEMM_GUSTAVSON:
        return nf
    raise ValueError(cls)


def _np_output_density(kf, d_mk: float, d_kn: float):
    """Vectorized ``costmodel.output_density`` over an array of (int-valued
    float) K extents, *bit-equal* to the scalar: ``np.exp`` does not
    reproduce ``math.exp`` to the last ulp on every libm, so the
    transcendentals run through scalar ``math`` over the unique K values
    (a template sweep has at most ~10 distinct K splits)."""
    p = d_mk * d_kn
    if p >= 1.0:
        return np.ones_like(kf)
    lg = math.log1p(-p)
    uniq, inv = np.unique(kf, return_inverse=True)
    lut = np.array([1.0 - math.exp(kv * lg) for kv in uniq])
    return lut[inv].reshape(np.shape(kf))


def _np_operand_bytes(cls: DataflowClass, mf, kf, nf, d_mk: float,
                      d_kn: float, mirror: bool, scratch=None):
    def dense(r, c):
        return r * c * cm.WORD

    def compressed(r, c, d, fibers):
        return r * c * d * (cm.WORD + cm.IDX) + fibers * cm.IDX

    if cls == DataflowClass.GEMM:
        a, b = dense(mf, kf), dense(kf, nf)
    elif cls == DataflowClass.SPMM:
        if mirror:
            a, b = compressed(mf, kf, d_mk, mf), dense(kf, nf)
        else:
            a, b = dense(mf, kf), compressed(kf, nf, d_kn, nf)
    elif cls == DataflowClass.SPGEMM_INNER:
        a, b = compressed(mf, kf, d_mk, mf), compressed(kf, nf, d_kn, nf)
    elif cls == DataflowClass.SPGEMM_OUTER:
        a, b = compressed(mf, kf, d_mk, kf), compressed(kf, nf, d_kn, kf)
    elif cls == DataflowClass.SPGEMM_GUSTAVSON:
        a, b = compressed(mf, kf, d_mk, kf), compressed(kf, nf, d_kn, nf)
    else:
        raise ValueError(cls)
    d_out = _np_output_density(kf, d_mk, d_kn)
    out = np.where(d_out < 0.5, compressed(mf, nf, d_out, mf), dense(mf, nf))
    total = a + b + out
    if cm.reuse_aware_traffic():
        # Mirror costmodel.operand_bytes exactly (DESIGN.md §4 contract).
        total = total + cm.restream_extra_bytes(cls, a, b, out, mirror,
                                                scratch_bytes=scratch)
    return total


def _batch_template_eval(config: cm.AcceleratorConfig, w: Workload,
                         fm, fk, fn):
    """Vectorized (runtime_s, energy_pj, valid) of the Fig 6e template over
    arrays of fraction triples — one numpy sweep instead of hundreds of
    per-triple ``_template_partitions`` + ``_evaluate`` Python calls. The
    arithmetic mirrors ``costmodel.partition_cost``/``aggregate`` exactly.
    """
    D = DataflowClass
    gemm_cl = config.clusters_supporting(D.GEMM)
    spmm_cl = config.clusters_supporting(D.SPMM)
    inner_cl = config.clusters_supporting(D.SPGEMM_INNER)
    outer_cl = config.clusters_supporting(D.SPGEMM_OUTER)
    gust_cl = config.clusters_supporting(D.SPGEMM_GUSTAVSON)

    t = len(fm)
    m_s = np.rint(w.m * np.asarray(fm, float)).astype(np.int64)
    k_s = np.rint(w.k * np.asarray(fk, float)).astype(np.int64)
    n_s = np.rint(w.n * np.asarray(fn, float)).astype(np.int64)
    full_m = np.full(t, w.m, np.int64)

    # K1 block: K-parallel classes, N split proportional to usable PEs.
    k1 = w.k - k_s
    has_k1 = k_s < w.k
    po = (np.minimum(config.clusters[outer_cl[0]].pes, k1)
          if outer_cl else np.zeros(t, np.int64))
    pg = (min(config.clusters[gust_cl[0]].pes, w.n) if gust_cl else 0)
    denom = po + pg
    n_mid = np.rint(w.n * po / np.maximum(denom, 1)).astype(np.int64)
    k1_eff = np.where(has_k1, k1, 0)

    slots = (
        (D.GEMM, gemm_cl, False, m_s, k_s, n_s),
        (D.SPMM, spmm_cl, True, w.m - m_s, k_s, n_s),
        (D.SPMM, spmm_cl, False, m_s, k_s, w.n - n_s),
        (D.SPGEMM_INNER, inner_cl, False, w.m - m_s, k_s, w.n - n_s),
        (D.SPGEMM_OUTER, outer_cl, False, full_m, k1_eff, n_mid),
        (D.SPGEMM_GUSTAVSON, gust_cl, False, full_m, k1_eff, w.n - n_mid),
    )

    valid = ~(has_k1 & (denom == 0))
    has_any = np.zeros(t, bool)
    cluster_cycles = np.zeros((t, len(config.clusters)))
    total_bytes = np.zeros(t)
    effectual = np.zeros(t)
    for cls, cl_ids, mirror, ms, ks, ns in slots:
        nonempty = (ms > 0) & (ks > 0) & (ns > 0)
        if not cl_ids:
            valid &= ~nonempty  # region needs a cluster nobody provides
            continue
        has_any |= nonempty
        cluster = config.clusters[cl_ids[0]]
        mf, kf, nf = (x.astype(float) for x in (ms, ks, ns))
        trips = _np_tripcount(cls, mf, kf, nf, w.d_mk, w.d_kn, mirror)
        p_eff = np.minimum(float(cluster.pes),
                           _np_parallelism_bound(cls, mf, kf, nf, mirror))
        cycles = np.where(nonempty,
                          np.ceil(trips / np.maximum(p_eff, 1.0)), 0.0)
        cluster_cycles[:, cl_ids[0]] += cycles
        total_bytes += np.where(
            nonempty,
            _np_operand_bytes(cls, mf, kf, nf, w.d_mk, w.d_kn, mirror,
                              scratch=config.scratchpad_bytes), 0.0)
        effectual += np.where(nonempty, mf * kf * nf * w.d_mk * w.d_kn, 0.0)
    valid &= has_any

    # Aggregate exactly as costmodel.aggregate does per-schedule: powered
    # clusters (those with any cycles) burn full power over the runtime,
    # unused clusters are power-gated. Powered power accumulates cluster by
    # cluster in config order — a BLAS matmul would reassociate the sum and
    # drift from the scalar path by ulps.
    compute_s = cluster_cycles.max(axis=1) / hwdb.FREQ_HZ
    mem_s = (np.zeros(t) if math.isinf(config.hbm_bw)
             else total_bytes / config.hbm_bw)
    runtime_s = np.maximum(np.maximum(compute_s, mem_s), 1e-12)
    powered_mw = np.zeros(t)
    for ci, c in enumerate(config.clusters):
        powered_mw += np.where(cluster_cycles[:, ci] > 0.0,
                               c.power_mw_per_pe * c.pes, 0.0)
    energy_pj = (
        powered_mw * (runtime_s * hwdb.FREQ_HZ)
        + total_bytes * (hwdb.E_HBM_PER_BYTE + hwdb.E_SCRATCH_PER_BYTE)
        + effectual * hwdb.E_MAC
    )
    return runtime_s, energy_pj, valid


# ------------------------------------- candidate-axis (joint-space) search
def batch_template_eval_joint(batch: cm.ConfigBatch, w: Workload,
                              fm, fk, fn):
    """Fig 6e template sweep with the candidate axis vectorized alongside
    the triple axis: (runtime_s, energy_pj, valid) as ``(n, t)`` arrays
    over ``n`` candidate designs × ``t`` fraction triples.

    The generalisation of :func:`_batch_template_eval` the joint DSE runs
    on — same slot order, same validity rules, same exact arithmetic
    (scalar-``math`` transcendentals via :func:`_np_output_density`,
    cluster-ordered power accumulation), with the per-candidate PE counts,
    HBM bandwidth and scratchpad capacity broadcast against the triples.
    """
    D = DataflowClass
    n, t = batch.n, len(fm)
    pes_i = batch.pes
    pes_f = pes_i.astype(float)
    idx = {c: j for j, c in enumerate(batch.classes)}
    scratch = batch.scratchpad_bytes[:, None]

    def pes_of(cls_):
        j = idx.get(cls_)
        return pes_i[:, j] if j is not None else np.zeros(n, np.int64)

    m_s = np.rint(w.m * np.asarray(fm, float)).astype(np.int64)   # (t,)
    k_s = np.rint(w.k * np.asarray(fk, float)).astype(np.int64)
    n_s = np.rint(w.n * np.asarray(fn, float)).astype(np.int64)
    full_m = np.full(t, w.m, np.int64)

    # K1 block: the N split between the K-parallel classes depends on the
    # candidate's PE counts, so n_mid picks up the candidate axis: (n, t).
    k1 = w.k - k_s
    has_k1 = k_s < w.k
    po = np.minimum(pes_of(D.SPGEMM_OUTER)[:, None], k1[None, :])
    pg = np.minimum(pes_of(D.SPGEMM_GUSTAVSON), w.n)[:, None]
    denom = po + pg
    n_mid = np.rint(w.n * po / np.maximum(denom, 1)).astype(np.int64)
    k1_eff = np.where(has_k1, k1, 0)

    slots = (
        (D.GEMM, False, m_s, k_s, n_s),
        (D.SPMM, True, w.m - m_s, k_s, n_s),
        (D.SPMM, False, m_s, k_s, w.n - n_s),
        (D.SPGEMM_INNER, False, w.m - m_s, k_s, w.n - n_s),
        (D.SPGEMM_OUTER, False, full_m, k1_eff, n_mid),
        (D.SPGEMM_GUSTAVSON, False, full_m, k1_eff, w.n - n_mid),
    )

    valid = ~(has_k1[None, :] & (denom == 0))
    has_any = np.zeros((n, t), bool)
    cc: Dict[int, np.ndarray] = {}
    total_bytes = np.zeros((n, t))
    effectual = np.zeros((n, t))
    for cls_, mirror, ms, ks, ns in slots:
        nonempty = (ms > 0) & (ks > 0) & (ns > 0)       # (t,) or (n, t)
        j = idx.get(cls_)
        present = ((pes_i[:, j] > 0) if j is not None
                   else np.zeros(n, bool))[:, None]
        valid &= ~(nonempty & ~present)  # region needs an absent cluster
        if j is None:
            continue
        live = nonempty & present
        has_any |= live
        mf, kf, nf = (np.asarray(x, float) for x in (ms, ks, ns))
        trips = _np_tripcount(cls_, mf, kf, nf, w.d_mk, w.d_kn, mirror)
        p_eff = np.minimum(pes_f[:, j][:, None],
                           _np_parallelism_bound(cls_, mf, kf, nf, mirror))
        cycles = np.where(live,
                          np.ceil(trips / np.maximum(p_eff, 1.0)), 0.0)
        cc[j] = cc.get(j, 0.0) + cycles
        total_bytes = total_bytes + np.where(
            live,
            _np_operand_bytes(cls_, mf, kf, nf, w.d_mk, w.d_kn, mirror,
                              scratch=scratch), 0.0)
        effectual += np.where(live, mf * kf * nf * w.d_mk * w.d_kn, 0.0)
    valid &= has_any

    compute_cycles = np.zeros((n, t))
    for arr in cc.values():
        compute_cycles = np.maximum(compute_cycles, arr)
    mem_s = total_bytes / batch.hbm_bw[:, None]   # x/inf == 0.0, as scalar
    runtime_s = np.maximum(
        np.maximum(compute_cycles / hwdb.FREQ_HZ, mem_s), 1e-12)
    powered_mw = np.zeros((n, t))
    for j in sorted(cc):   # ascending class index == config cluster order
        nameplate = (hwdb.PROFILES[batch.classes[j]].power_mw_per_pe
                     * pes_f[:, j])[:, None]
        powered_mw += np.where(cc[j] > 0.0, nameplate, 0.0)
    energy_pj = (
        powered_mw * (runtime_s * hwdb.FREQ_HZ)
        + total_bytes * (hwdb.E_HBM_PER_BYTE + hwdb.E_SCRATCH_PER_BYTE)
        + effectual * hwdb.E_MAC
    )
    return runtime_s, energy_pj, valid


def batch_single_kernel_eval(batch: cm.ConfigBatch, w: Workload,
                             fracs: Sequence[float] = _FRACS,
                             refine: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Single-kernel schedule search for ``n`` candidate designs in one
    numpy pass: ``(runtime_s, energy_pj)`` as (n,) arrays.

    For every feasible candidate ``i`` this equals — bit for bit — the
    scalar ``schedule_single_kernel(batch.config(i), w, fracs, refine)``
    report: the whole-kernel candidates are scanned in the same order with
    the same strict-``<`` (runtime, energy) tie-breaking, the template
    winner replicates the scalar argmin (first index on ties, fine grid
    masked off for single-cluster candidates exactly as the scalar path
    skips it), and every arithmetic operation preserves the scalar
    evaluation order. Infeasible candidates (no clusters) return ``inf``.
    """
    n = batch.n
    pes_f = batch.pes.astype(float)
    bw = batch.hbm_bw
    reuse = cm.reuse_aware_traffic()
    e_byte = hwdb.E_HBM_PER_BYTE + hwdb.E_SCRATCH_PER_BYTE

    best_rt = np.full(n, np.inf)
    best_en = np.full(n, np.inf)

    def consider(rt, en, ok):
        nonlocal best_rt, best_en
        better = ok & ((rt < best_rt) | ((rt == best_rt) & (en < best_en)))
        best_rt = np.where(better, rt, best_rt)
        best_en = np.where(better, en, best_en)

    # Whole-kernel candidates, in _whole_kernel_candidates order: clusters
    # in batch-class order, SPMM mirror=False before mirror=True.
    effectual = float(w.m) * w.k * w.n * w.d_mk * w.d_kn
    for j, cls_ in enumerate(batch.classes):
        present = batch.pes[:, j] > 0
        if not present.any():
            continue
        power_pe = hwdb.PROFILES[cls_].power_mw_per_pe
        orients = ((False, True) if cls_ == DataflowClass.SPMM
                   else (False,))
        for mirror in orients:
            trips = cm.tripcount(cls_, w.m, w.k, w.n, w.d_mk, w.d_kn,
                                 mirror)
            bound = cm.parallelism_bound(cls_, w.m, w.k, w.n, mirror)
            p_eff = np.minimum(pes_f[:, j], bound)
            cycles = np.ceil(trips / np.maximum(p_eff, 1.0))
            a, b, out = cm.operand_components(cls_, w.m, w.k, w.n,
                                              w.d_mk, w.d_kn, mirror)
            nbytes = a + b + out
            if reuse:
                nbytes = nbytes + cm.restream_extra_bytes(
                    cls_, a, b, out, mirror,
                    scratch_bytes=batch.scratchpad_bytes)
            mem_s = nbytes / bw
            runtime_s = np.maximum(
                np.maximum(cycles / hwdb.FREQ_HZ, mem_s), 1e-12)
            powered = np.where(cycles > 0.0, power_pe * pes_f[:, j], 0.0)
            energy_pj = (powered * (runtime_s * hwdb.FREQ_HZ)
                         + nbytes * e_byte + effectual * hwdb.E_MAC)
            consider(runtime_s, energy_pj, present)

    # Template sweep: coarse grid for everyone; the fine grid only for
    # multi-cluster candidates (the scalar path appends it only when
    # refine=True and len(config.clusters) > 1).
    fracs = tuple(fracs)
    triples = list(itertools.product(fracs, fracs, fracs))
    t_coarse = len(triples)
    multi = (batch.pes > 0).sum(axis=1) > 1
    use_fine = refine and bool(multi.any())
    if use_fine:
        triples += list(itertools.product(_FRACS_FINE, _FRACS_FINE,
                                          _FRACS_FINE))
    fm = np.array([x[0] for x in triples])
    fk = np.array([x[1] for x in triples])
    fn = np.array([x[2] for x in triples])
    rt, en, valid = batch_template_eval_joint(batch, w, fm, fk, fn)
    if use_fine:
        valid[:, t_coarse:] &= multi[:, None]
    rt_m = np.where(valid, rt, np.inf)
    rt_min = rt_m.min(axis=1)
    en_m = np.where(valid & (rt_m == rt_min[:, None]), en, np.inf)
    ti = np.argmin(en_m, axis=1)   # first (runtime, energy) min per row
    rows = np.arange(n)
    consider(rt_m[rows, ti], en_m[rows, ti], valid.any(axis=1))
    return best_rt, best_en


def schedule_single_kernel(
    config: cm.AcceleratorConfig,
    w: Workload,
    fracs: Sequence[float] = _FRACS,
    refine: bool = True,
    memo: bool = False,
) -> KernelSchedule:
    """Search partitionings (paper §V-A) minimising runtime, then energy.

    The whole-kernel candidates (a handful) are scored through the scalar
    cost model; the template fraction sweep (hundreds of triples) is scored
    in one vectorized numpy pass and only the winning triple is rebuilt
    into explicit partitions.

    ``memo=True`` serves repeated ``(config, workload, fracs, refine)``
    queries from a process-wide LRU cache — the DSE engine re-evaluates
    the same workload under hundreds of candidate configs (and the
    refinement stage revisits fraction vectors), and ``KernelSchedule`` is
    deeply frozen, so sharing instances is safe. The cache is also what
    makes the ``optimized`` policy's straggler-split queries cheap during
    design × policy co-DSE (see :func:`clear_schedule_cache`).
    """
    if memo:
        return _schedule_single_kernel_memo(config, w, tuple(fracs),
                                            bool(refine))
    return _schedule_single_kernel_impl(config, w, fracs, refine)


@functools.lru_cache(maxsize=65536)
def _schedule_single_kernel_memo(config, w, fracs, refine):
    return _schedule_single_kernel_impl(config, w, fracs, refine)


def clear_schedule_cache() -> None:
    """Drop the memoized single-kernel schedules and per-cluster bests
    (tests and long-lived servers call this between model changes)."""
    _schedule_single_kernel_memo.cache_clear()
    _best_on_cluster.cache_clear()


def schedule_cache_info() -> Dict[str, Dict[str, int]]:
    """Hit/miss/size of the process-wide schedule memo caches — the
    single-kernel schedule LRU and the per-(cluster, task) best-mapping
    LRU — in one dict."""
    out: Dict[str, Dict[str, int]] = {}
    for name, fn in (("single_kernel_memo", _schedule_single_kernel_memo),
                     ("best_on_cluster", _best_on_cluster)):
        ci = fn.cache_info()
        out[name] = {"hits": ci.hits, "misses": ci.misses,
                     "maxsize": ci.maxsize, "currsize": ci.currsize}
    return out


def _schedule_single_kernel_impl(
    config: cm.AcceleratorConfig,
    w: Workload,
    fracs: Sequence[float],
    refine: bool,
) -> KernelSchedule:
    best: Optional[Tuple[float, float, Tuple[Partition, ...], cm.KernelReport]] = None

    def consider(parts: Optional[Tuple[Partition, ...]]):
        nonlocal best
        if not parts:
            return
        rep = _evaluate(config, w, parts)
        key = (rep.runtime_s, rep.energy_pj)
        if best is None or key < (best[0], best[1]):
            best = (rep.runtime_s, rep.energy_pj, parts, rep)

    for parts in _whole_kernel_candidates(config, w):
        consider(parts)

    triples = list(itertools.product(fracs, fracs, fracs))
    if refine and len(config.clusters) > 1:
        # Refinement grid at 1/8 step (appended after the coarse grid so
        # tie-breaking still favours the coarse candidates, as before).
        triples += list(itertools.product(_FRACS_FINE, _FRACS_FINE,
                                          _FRACS_FINE))
    fm = np.array([x[0] for x in triples])
    fk = np.array([x[1] for x in triples])
    fn = np.array([x[2] for x in triples])
    runtime_s, energy_pj, valid = _batch_template_eval(config, w, fm, fk, fn)
    if valid.any():
        rt = np.where(valid, runtime_s, np.inf)
        en = np.where(valid & (rt == rt.min()), energy_pj, np.inf)
        i = int(np.argmin(en))  # first lexicographic (runtime, energy) min
        consider(_template_partitions(config, w, *triples[i]))
    assert best is not None, "no feasible schedule"

    return KernelSchedule(w, config, best[2], best[3])


# --------------------------------------------------------------- many-kernel
@dataclasses.dataclass(frozen=True)
class PlacedPartition:
    """One partition of a (possibly split) task on a cluster's timeline."""

    partition: Partition
    start_cycles: float
    cycles: float

    @property
    def finish_cycles(self) -> float:
        return self.start_cycles + self.cycles


@dataclasses.dataclass(frozen=True)
class TaskAssignment:
    """Placement of one queued kernel.

    ``placed`` carries the per-partition timeline; whole-kernel tasks have
    exactly one entry covering the full M×K×N region, tasks split by the
    ``optimized`` policy have one entry per cluster-resident partition.
    The scalar fields (``cluster``/``cls``/``mirror``/``start``/``cycles``)
    summarise the first partition and the wall-clock span of the task.
    """

    workload: Workload
    cluster: int
    cls: DataflowClass
    mirror: bool
    start_cycles: float
    cycles: float
    report: cm.KernelReport
    task_index: int = -1            # position in the scheduled task queue
    arrival_cycles: float = 0.0
    placed: Tuple[PlacedPartition, ...] = ()

    @property
    def split(self) -> bool:
        return len(self.placed) > 1

    @property
    def finish_cycles(self) -> float:
        if self.placed:
            return max(p.finish_cycles for p in self.placed)
        return self.start_cycles + self.cycles

    @property
    def wait_cycles(self) -> float:
        return self.start_cycles - self.arrival_cycles


@dataclasses.dataclass(frozen=True)
class ManyKernelSchedule:
    config: cm.AcceleratorConfig
    assignments: Tuple[TaskAssignment, ...]
    makespan_cycles: float
    total_bytes: float
    energy_pj: float
    policy: str = "lpt"
    stats: Optional[cm.QueueStats] = None

    @property
    def makespan_s(self) -> float:
        compute_s = self.makespan_cycles / hwdb.FREQ_HZ
        mem_s = (0.0 if math.isinf(self.config.hbm_bw)
                 else self.total_bytes / self.config.hbm_bw)
        return max(compute_s, mem_s)


@functools.lru_cache(maxsize=65536)
def _best_on_cluster(cluster: cm.ClusterSpec, w: Workload,
                     scratch_bytes: float = hwdb.SCRATCH_BYTES
                     ) -> Tuple[float, DataflowClass, bool, cm.PartitionCost]:
    """Fastest (class, orientation) for this kernel on this cluster.

    Memoized (the arguments are frozen dataclasses plus the owning
    config's scratchpad capacity, which reaches the reuse-aware traffic
    model and so belongs in the cache key): list scheduling re-queries
    every (cluster, task) pair once for LPT ordering and once per
    placement round — the cache collapses those to one evaluation.
    """
    best = None
    for cls in cluster.supported:
        orients = (False, True) if cls == DataflowClass.SPMM else (False,)
        for mirror in orients:
            c = cm.partition_cost(cls, cluster, w.m, w.k, w.n,
                                  w.d_mk, w.d_kn, mirror=mirror,
                                  scratch_bytes=scratch_bytes)
            if best is None or c.cycles < best[0]:
                best = (c.cycles, cls, mirror, c)
    assert best is not None
    return best


# ---------------------------------------------------------- policy registry
class SchedulingPolicy:
    """Greedy list scheduling with release times (the shared engine).

    Subclasses pick the *priority* (which arrived task goes next) and the
    *placement* (which cluster takes it). The engine is online: decisions
    happen at cluster-free events, and only tasks whose ``arrival`` has
    passed compete at each one — so the same policies serve the offline
    Fig 12 sweep (all arrivals 0) and the multi-tenant queueing
    simulation, and a late-arriving short job really can overtake queued
    long ones under ``sjf``. The event loop itself lives in
    :class:`OnlineScheduler`, so a serving runtime can step it
    incrementally instead of re-planning the whole backlog per event.
    """

    name = "base"

    def priority(self, w: Workload, idx: int, best_cycles: float):
        """Sort key among arrived tasks — smallest schedules first."""
        raise NotImplementedError

    def eligible_clusters(self, config: cm.AcceleratorConfig, w: Workload):
        """Clusters this policy would consider placing ``w`` on — the
        engine defers a task until one of these is free, so queued tasks
        compete by priority at the *relevant* cluster-free event."""
        return range(len(config.clusters))

    def place(self, config: cm.AcceleratorConfig, ready: List[float],
              w: Workload, arrival: float):
        """Pick a cluster: default = earliest finish time (list scheduling).

        Returns ``(ci, start, cyc, cls, mirror, cost)``.
        """
        options = []
        for ci, cluster in enumerate(config.clusters):
            cyc, cls, mirror, cost = _best_on_cluster(
                cluster, w, config.scratchpad_bytes)
            start = max(ready[ci], arrival)
            options.append((start + cyc, ci, start, cyc, cls, mirror, cost))
        finish, ci, start, cyc, cls, mirror, cost = min(
            options, key=lambda o: (o[0], o[1]))
        return ci, start, cyc, cls, mirror, cost

    def postprocess(self, config: cm.AcceleratorConfig,
                    assignments: List[TaskAssignment],
                    ready: List[float]
                    ) -> Tuple[List[TaskAssignment], List[float]]:
        """Whole-schedule rewrite hook, applied once the queue is drained
        (offline) or the trace is complete (serving runtime). The base
        policies place tasks greedily and leave the schedule alone; the
        ``optimized`` policy rewrites the makespan straggler here."""
        return assignments, ready

    def schedule(self, config: cm.AcceleratorConfig,
                 tasks: Sequence[Workload],
                 arrivals: Optional[Sequence[float]] = None
                 ) -> ManyKernelSchedule:
        tasks = list(tasks)
        arr = ([0.0] * len(tasks) if arrivals is None
               else [float(a) for a in arrivals])
        if len(arr) != len(tasks):
            raise ValueError(f"{len(tasks)} tasks but {len(arr)} arrivals")
        engine = OnlineScheduler(config, self)
        for i, (w, a) in enumerate(zip(tasks, arr)):
            engine.offer(w, arrival=a, index=i)
        engine.drain()
        return engine.finish()


@dataclasses.dataclass
class _QueuedTask:
    """One offered-but-unplaced task in the engine backlog."""

    index: int
    workload: Workload
    arrival: float
    best_cycles: float


# ------------------------------------------------------------ observability
# Engine events recorded on the VIRTUAL timebase (modelled cycles →
# microseconds via costmodel.cycles_to_us), copied from the JAX package.
# The hooks are module-level functions called unconditionally from the
# engine — they early-return while tracing is disabled, and being plain
# module globals they can be monkeypatched to no-ops.
_MET_OFFERS = _obs.METRICS.counter("scheduler.offers")
_MET_PLACEMENTS = _obs.METRICS.counter("scheduler.placements")
_MET_DEFERRALS = _obs.METRICS.counter("scheduler.deferrals")


def _sched_tid(sched: "OnlineScheduler") -> str:
    return f"scheduler[{sched.policy.name}]"


def _cluster_tid(sched: "OnlineScheduler", ci: int) -> str:
    return f"cluster{ci}:{sched.config.clusters[ci].name}"


def _trace_offer(sched: "OnlineScheduler", q: _QueuedTask) -> None:
    _MET_OFFERS.inc()
    if not _trace_mod.ENABLED:
        return
    tid = _sched_tid(sched)
    ts = cm.cycles_to_us(q.arrival)
    _trace_mod.TRACE.instant(
        "offer", ts, pid=_trace_mod.PID_VIRTUAL, tid=tid, cat="scheduler",
        task=q.index, m=q.workload.m, k=q.workload.k, n=q.workload.n,
        best_cycles=q.best_cycles)
    _trace_mod.TRACE.counter(
        "queue_depth", float(sched.queue_depth), ts,
        pid=_trace_mod.PID_VIRTUAL, tid=tid)


def _trace_place(sched: "OnlineScheduler", q: _QueuedTask,
                 a: TaskAssignment) -> None:
    _MET_PLACEMENTS.inc()
    if not _trace_mod.ENABLED:
        return
    tr = _trace_mod.TRACE
    ts_now = cm.cycles_to_us(sched.now)
    tr.instant(
        "dispatch", ts_now, pid=_trace_mod.PID_VIRTUAL,
        tid=_sched_tid(sched), cat="scheduler",
        task=q.index, policy=sched.policy.name, cluster=a.cluster,
        cls=a.cls.value, wait_cycles=a.wait_cycles,
        ready_cycles=[round(r, 1) for r in sched.ready])
    for pp in a.placed:
        tr.complete(
            f"task{q.index}", cm.cycles_to_us(pp.start_cycles),
            cm.cycles_to_us(pp.cycles), pid=_trace_mod.PID_VIRTUAL,
            tid=_cluster_tid(sched, pp.partition.cluster), cat="task",
            task=q.index, cls=pp.partition.cls.value,
            mirror=pp.partition.mirror,
            arrival_cycles=q.arrival, policy=sched.policy.name)
    tr.counter("queue_depth", float(sched.queue_depth), ts_now,
               pid=_trace_mod.PID_VIRTUAL, tid=_sched_tid(sched))


def _trace_defer(sched: "OnlineScheduler", now: float, nxt: float,
                 n_arrived: int) -> None:
    _MET_DEFERRALS.inc()
    if not _trace_mod.ENABLED:
        return
    _trace_mod.TRACE.instant(
        "defer", cm.cycles_to_us(now), pid=_trace_mod.PID_VIRTUAL,
        tid=_sched_tid(sched), cat="scheduler",
        arrived=n_arrived, backlog=len(sched._backlog),
        next_event_cycles=nxt)


_obs.METRICS.register_callback("scheduler.caches", schedule_cache_info)


class OnlineScheduler:
    """Incremental, event-stepped list-scheduling engine.

    The offline :meth:`SchedulingPolicy.schedule` and the serving runtime
    (``repro_torch.serve.cluster.ClusterServer``) share this engine:

    * :meth:`offer` makes a task visible from ``arrival`` cycles on;
    * :meth:`advance` processes arrival/cluster-free events with cursor
      times strictly below ``until`` — placements already committed may
      extend past it, but no new *decision* is taken at or after ``until``,
      so tasks offered later (at ``until``) still compete at that event
      exactly as the offline engine would have let them;
    * :meth:`drain` runs the backlog to empty; :meth:`finish` applies the
      policy's whole-schedule :meth:`~SchedulingPolicy.postprocess` and
      wraps everything into a :class:`ManyKernelSchedule`.

    Offering every task up front and draining reproduces the offline
    schedule bit-for-bit (that is how ``schedule_many_kernels`` is now
    implemented); the server instead interleaves bounded advances with
    offers, so admission decisions see exactly the requests that have
    arrived — without ever re-planning the committed backlog.
    """

    def __init__(self, config: cm.AcceleratorConfig,
                 policy: "str | SchedulingPolicy" = "lpt",
                 ready: Optional[Sequence[float]] = None):
        self.config = config
        self.policy = (policy if isinstance(policy, SchedulingPolicy)
                       else get_policy(policy))
        self.ready: List[float] = ([0.0] * len(config.clusters)
                                   if ready is None else list(ready))
        if len(self.ready) != len(config.clusters):
            raise ValueError(
                f"{len(self.ready)} ready entries for "
                f"{len(config.clusters)} clusters")
        self.now = 0.0
        self.assignments: List[TaskAssignment] = []
        self._backlog: List[_QueuedTask] = []
        self._next_index = 0

    @property
    def backlog_depth(self) -> int:
        """Offered tasks not yet placed on any cluster timeline."""
        return len(self._backlog)

    @property
    def queue_depth(self) -> int:
        """Tasks offered but not yet *started* at the cursor: the backlog
        plus placements committed into the future (admission signal)."""
        return len(self._backlog) + sum(
            a.start_cycles > self.now for a in self.assignments)

    def offer(self, w: Workload, arrival: float = 0.0,
              index: Optional[int] = None) -> int:
        """Make a task visible to the engine from ``arrival`` cycles on
        (clamped to the cursor — the engine cannot revisit the past).
        Returns the task index recorded in its eventual assignment."""
        if index is None:
            index = self._next_index
        self._next_index = max(self._next_index, index + 1)
        best = min(_best_on_cluster(c, w, self.config.scratchpad_bytes)[0]
                   for c in self.config.clusters)
        q = _QueuedTask(index, w, max(float(arrival), self.now), best)
        self._backlog.append(q)
        _trace_offer(self, q)
        return index

    def _place(self, q: _QueuedTask) -> TaskAssignment:
        w = q.workload
        ci, start, cyc, cls, mirror, cost = self.policy.place(
            self.config, self.ready, w, q.arrival)
        rep = cm.aggregate(self.config, {ci: cyc}, [cost])
        whole = Region(0, w.m, 0, w.k, 0, w.n)
        a = TaskAssignment(
            w, ci, cls, mirror, start, cyc, rep,
            task_index=q.index, arrival_cycles=q.arrival,
            placed=(PlacedPartition(
                Partition(whole, cls, ci, mirror), start, cyc),),
        )
        self.ready[ci] = start + cyc
        self._backlog.remove(q)
        self.assignments.append(a)
        _trace_place(self, q, a)
        return a

    def advance(self, until: Optional[float] = None
                ) -> List[TaskAssignment]:
        """Process events at cursor times strictly before ``until``
        (``None`` = no bound); returns the assignments placed."""
        placed: List[TaskAssignment] = []
        backlog = self._backlog
        ready = self.ready
        policy = self.policy
        config = self.config
        # Policies that don't restrict placement eligibility (all but
        # `affinity`) share one free time per event — hoist it out of the
        # per-task eligibility probe (this loop is the DSE hot path).
        base_eligible = (type(policy).eligible_clusters
                         is SchedulingPolicy.eligible_clusters)

        def eef(q: _QueuedTask) -> float:
            return min(ready[c] for c in
                       policy.eligible_clusters(config, q.workload))

        now = self.now
        while backlog:
            if until is not None and now >= until:
                break
            arrived = [q for q in backlog if q.arrival <= now]
            if not arrived:
                nxt = min(q.arrival for q in backlog)
                if until is not None and nxt >= until:
                    break
                now = nxt
                continue
            if base_eligible:
                free = min(ready)
                startable = arrived if free <= now else []
            else:
                startable = [q for q in arrived if eef(q) <= now]
            if not startable:
                # Every eligible cluster busy: defer the decision to the
                # next eligible-cluster-free event (or next arrival, which
                # may be startable sooner) so queued tasks compete by
                # priority — committing at arrival would reduce every
                # priority rule to FIFO.
                nxt = min(([free] if base_eligible
                           else [eef(q) for q in arrived])
                          + [q.arrival for q in backlog if q.arrival > now])
                _trace_defer(self, now, nxt, len(arrived))
                if until is not None and nxt >= until:
                    break
                now = nxt
                continue
            q = min(startable, key=lambda x: policy.priority(
                x.workload, x.index, x.best_cycles))
            self.now = now
            placed.append(self._place(q))
        self.now = now if until is None else max(now, until)
        return placed

    def drain(self) -> List[TaskAssignment]:
        """Run the backlog to empty (no time bound)."""
        return self.advance(None)

    def fork(self) -> "OnlineScheduler":
        """Speculative copy sharing the (immutable) config/policy but
        owning private timelines and backlog: drain the fork to look
        ahead without committing anything to this engine (the fleet
        launcher's fault-injection lookahead)."""
        eng = OnlineScheduler(self.config, self.policy,
                              ready=list(self.ready))
        eng.now = self.now
        eng.assignments = list(self.assignments)
        eng._backlog = [dataclasses.replace(q) for q in self._backlog]
        eng._next_index = self._next_index
        return eng

    def live_stats(self) -> cm.QueueStats:
        """Queueing snapshot at the cursor — the *live* ``QueueStats`` the
        serving front-end's admission control reads: busy fractions over
        ``[0, now]``, waits of started tasks plus the still-growing waits
        of the backlog, turnarounds of finished tasks, and the current
        queue depth."""
        t = self.now
        busy = [0.0] * len(self.config.clusters)
        waits, turns = [], []
        for a in self.assignments:
            for pp in a.placed:
                busy[pp.partition.cluster] += max(
                    0.0, min(pp.finish_cycles, t) - min(pp.start_cycles, t))
            if a.start_cycles <= t:
                waits.append(a.wait_cycles)
            else:
                waits.append(t - a.arrival_cycles)
            if a.finish_cycles <= t:
                turns.append(a.finish_cycles - a.arrival_cycles)
        waits.extend(t - q.arrival for q in self._backlog)
        return cm.queue_stats(self.config, busy, waits, turns, t,
                              queue_depth=self.queue_depth)

    def finish(self) -> ManyKernelSchedule:
        """Apply the policy's whole-schedule postprocess and package the
        placements (drained or not) into a :class:`ManyKernelSchedule`."""
        assignments, ready = self.policy.postprocess(
            self.config, list(self.assignments), list(self.ready))
        makespan = max(ready) if ready else 0.0
        total_bytes = sum(a.report.bytes_moved for a in assignments)
        energy = sum(a.report.energy_pj for a in assignments)
        return ManyKernelSchedule(
            self.config, tuple(assignments), makespan, total_bytes, energy,
            policy=self.policy.name,
            stats=_queue_stats(self.config, assignments, makespan),
        )


def _queue_stats(config: cm.AcceleratorConfig,
                 assignments: Sequence[TaskAssignment],
                 makespan: float) -> cm.QueueStats:
    busy = [0.0] * len(config.clusters)
    for a in assignments:
        for pp in a.placed:
            busy[pp.partition.cluster] += pp.cycles
    waits = [a.wait_cycles for a in assignments]
    turns = [a.finish_cycles - a.arrival_cycles for a in assignments]
    return cm.queue_stats(config, busy, waits, turns, makespan)


#: name -> policy instance; populated by :func:`register_policy`.
POLICIES: Dict[str, SchedulingPolicy] = {}


def register_policy(cls):
    """Class decorator: instantiate and index a policy by its ``name``."""
    inst = cls()
    if not inst.name or inst.name == "base":
        raise ValueError(f"{cls.__name__} needs a distinct .name")
    POLICIES[inst.name] = inst
    return cls


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(POLICIES))


def get_policy(name: str) -> SchedulingPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown scheduling policy {name!r}; "
            f"registered: {', '.join(available_policies())}") from None


@register_policy
class LptPolicy(SchedulingPolicy):
    """Longest-processing-time first, earliest-finish placement — the
    paper's baseline list scheduler (and the seed behaviour, kept
    bit-equal: see tests/test_policies.py)."""

    name = "lpt"

    def priority(self, w, idx, best_cycles):
        return (-best_cycles, idx)


@register_policy
class SjfPolicy(SchedulingPolicy):
    """Shortest-job-first: minimises mean wait/turnaround under load —
    the latency-friendly multi-tenant policy (at some makespan cost)."""

    name = "sjf"

    def priority(self, w, idx, best_cycles):
        return (best_cycles, idx)


@register_policy
class AffinityPolicy(LptPolicy):
    """Sparsity/dimension-affinity matching (paper §V-B): every kernel goes
    to the cluster whose dataflow class handles its sparsity pattern and
    dimension-boundedness fastest (pure compute match), queueing behind
    that cluster rather than spilling onto a mismatched idle one.
    LPT priority; only matched clusters count as placement-eligible, so
    the engine holds queued tasks until *their* cluster frees."""

    name = "affinity"

    def eligible_clusters(self, config, w):
        cycs = [_best_on_cluster(c, w, config.scratchpad_bytes)[0]
                for c in config.clusters]
        fastest = min(cycs)
        return [ci for ci, cyc in enumerate(cycs) if cyc == fastest]

    def place(self, config, ready, w, arrival):
        options = []
        for ci, cluster in enumerate(config.clusters):
            cyc, cls, mirror, cost = _best_on_cluster(
                cluster, w, config.scratchpad_bytes)
            start = max(ready[ci], arrival)
            options.append((cyc, start, ci, cls, mirror, cost))
        cyc, start, ci, cls, mirror, cost = min(
            options, key=lambda o: (o[0], o[1], o[2]))
        return ci, start, cyc, cls, mirror, cost


@register_policy
class OptimizedPolicy(LptPolicy):
    """LPT, then split the makespan-defining straggler across clusters by
    reusing :func:`schedule_single_kernel` partitions (the paper's
    best-performing many-kernel strategy): while the critical cluster's
    last task can be partitioned and doing so shortens the makespan,
    replace it with its single-kernel multi-cluster split."""

    name = "optimized"

    def postprocess(self, config, assignments, ready):
        if not assignments or len(config.clusters) < 2:
            return assignments, ready
        for _ in range(len(assignments)):
            makespan = max(ready)
            crit = max(range(len(ready)), key=lambda c: ready[c])
            last = max((a for a in assignments
                        if not a.split
                        and a.placed[0].partition.cluster == crit
                        and a.finish_cycles >= makespan - 1e-9),
                       key=lambda a: a.finish_cycles, default=None)
            if last is None:
                break
            w = last.workload
            single = schedule_single_kernel(config, w, memo=True)
            parts = [p for p in single.partitions if not p.region.empty]
            if len(parts) <= 1:
                break
            # Tentative: free the straggler's slot, append each partition
            # to its cluster's queue tail.
            trial = list(ready)
            trial[crit] = last.placed[0].start_cycles
            placed: List[PlacedPartition] = []
            costs: List[cm.PartitionCost] = []
            per_cluster: Dict[int, float] = {}
            for p in parts:
                r = p.region
                c = cm.partition_cost(
                    p.cls, config.clusters[p.cluster], r.m, r.k, r.n,
                    w.d_mk, w.d_kn, mirror=p.mirror,
                    scratch_bytes=config.scratchpad_bytes)
                start = max(trial[p.cluster], last.arrival_cycles)
                placed.append(PlacedPartition(p, start, c.cycles))
                trial[p.cluster] = start + c.cycles
                costs.append(c)
                per_cluster[p.cluster] = (per_cluster.get(p.cluster, 0.0)
                                          + c.cycles)
            if max(trial) >= makespan - 1e-9:
                break
            rep = cm.aggregate(config, per_cluster, costs)
            first = min(placed, key=lambda pp: pp.start_cycles)
            finish = max(pp.finish_cycles for pp in placed)
            assignments[assignments.index(last)] = TaskAssignment(
                w, first.partition.cluster, first.partition.cls,
                first.partition.mirror, first.start_cycles,
                finish - first.start_cycles, rep,
                task_index=last.task_index,
                arrival_cycles=last.arrival_cycles, placed=tuple(placed))
            ready = trial
        return assignments, ready


def schedule_many_kernels(config: cm.AcceleratorConfig,
                          tasks: Sequence[Workload],
                          policy: "str | SchedulingPolicy" = "lpt",
                          arrivals: Optional[Sequence[float]] = None,
                          ) -> ManyKernelSchedule:
    """List-schedule a queue of independent kernels onto clusters.

    Each kernel keeps ONE format pair (paper §V-B) and runs entirely on one
    cluster — except under the ``optimized`` policy, which may split the
    makespan straggler across clusters via single-kernel partitioning.
    ``policy`` names a registered :class:`SchedulingPolicy`
    (:func:`available_policies`); ``arrivals`` (cycles, same length as
    ``tasks``) turns the schedule into an online queueing run whose
    wait/utilization aggregates land in ``schedule.stats``.
    """
    with _trace_mod.TRACE.span("repro.schedule", cat="queue",
                               tasks=len(tasks),
                               policy=getattr(policy, "name", policy)):
        pol = (policy if isinstance(policy, SchedulingPolicy)
               else get_policy(policy))
        return pol.schedule(config, tasks, arrivals)
