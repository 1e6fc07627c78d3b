"""Single-kernel scheduling for heterogeneous sparse accelerators (paper
§V-A), copied from ``repro.core.scheduler`` so the port carries no
dependency on the JAX package.

:func:`schedule_single_kernel` partitions ONE matmul across M/N/K into
regions of different compression formats, one per sub-accelerator cluster,
to maximise TFLOP/s on a latency-critical kernel (Fig 6). The schedule it
returns feeds both the analytical cost model and the numerical executor
(``repro_torch.core.hetero_matmul.execute_schedule``). Many-kernel
scheduling and its policies are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import hwdb
from repro_torch.core.workloads import Workload
from repro_torch.formats.taxonomy import DataflowClass


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
    """Drop the memoized single-kernel schedules (tests and long-lived
    servers call this between model changes)."""
    _schedule_single_kernel_memo.cache_clear()


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

