"""Analytical performance/energy model (paper §VI), the port of
``repro.core.costmodel`` as the schedulers, the DSE and the executor's
cost hook read it, copied so the port carries no dependency on the JAX
package.

Approximates each kernel's runtime by the tripcount of the compute loop of
its TACO kernel (Fig 2), divided by the usable PEs (bounded by the class's
parallelism dimension, Fig 1), at 1 GHz; integrates HBM bandwidth (sparse
kernels are often memory-bound); and charges energy for PE activity plus
on-chip/off-chip data movement. Uniform random sparsity assumed, as in the
paper.

Units: cycles (1 cycle = 1 ns at 1 GHz), bytes, pJ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hwdb
from repro_torch.formats.taxonomy import DataflowClass

WORD = 4          # int32/fp32 words, as in the paper's HLS designs
IDX = 4           # coordinate metadata word


# --------------------------------------------------------------- clusters
@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One sub-accelerator cluster inside an accelerator."""

    name: str
    supported: Tuple[DataflowClass, ...]
    pes: int
    area_mm2_per_pe: float
    power_mw_per_pe: float

    @property
    def area_mm2(self) -> float:
        return self.pes * self.area_mm2_per_pe

    def supports(self, cls: DataflowClass) -> bool:
        return cls in self.supported


def basic_cluster(cls: DataflowClass, pes: int) -> ClusterSpec:
    p = hwdb.PROFILES[cls]
    return ClusterSpec(cls.value, (cls,), pes, p.area_mm2_per_pe,
                       p.power_mw_per_pe)


def hybrid_cluster(pes: int) -> ClusterSpec:
    """Homogeneous-hybrid PE: supports TPU+EIE+ExTensor dataflows (Fig 1)."""
    return ClusterSpec(
        "hybrid",
        (DataflowClass.GEMM, DataflowClass.SPMM, DataflowClass.SPGEMM_INNER),
        pes, hwdb.HYBRID_AREA_PER_PE, hwdb.HYBRID_POWER_PER_PE,
    )


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """A (possibly heterogeneous) accelerator under the area constraint."""

    name: str
    clusters: Tuple[ClusterSpec, ...]
    hbm_bw: float = hwdb.HBM_BW      # bytes/s; math.inf = unlimited
    #: Global scratchpad capacity (bytes). A design-vector axis of the joint
    #: DSE space; only the reuse-aware traffic model reads it (re-streaming
    #: kicks in when a stationary operand overflows this capacity).
    scratchpad_bytes: float = hwdb.SCRATCH_BYTES

    @property
    def total_pes(self) -> int:
        return sum(c.pes for c in self.clusters)

    @property
    def area_mm2(self) -> float:
        return sum(c.area_mm2 for c in self.clusters)

    @property
    def peak_tflops(self) -> float:
        return hwdb.peak_tflops(self.total_pes)

    def clusters_supporting(self, cls: DataflowClass):
        return [i for i, c in enumerate(self.clusters) if c.supports(cls)]


# ------------------------------------------------------- canonical configs
def homogeneous(cls: DataflowClass, hbm_bw: float = hwdb.HBM_BW,
                scratchpad_bytes: float = hwdb.SCRATCH_BYTES
                ) -> AcceleratorConfig:
    pes = hwdb.PROFILES[cls].fig1_pes
    return AcceleratorConfig(f"homog_{cls.value}", (basic_cluster(cls, pes),),
                             hbm_bw, scratchpad_bytes)


def homogeneous_hybrid(hbm_bw: float = hwdb.HBM_BW,
                       scratchpad_bytes: float = hwdb.SCRATCH_BYTES
                       ) -> AcceleratorConfig:
    return AcceleratorConfig("homog_hybrid", (hybrid_cluster(hwdb.HYBRID_PES),),
                             hbm_bw, scratchpad_bytes)


def aespa_from_fractions(
    fractions: Dict[DataflowClass, float],
    name: str = "aespa",
    hbm_bw: float = hwdb.HBM_BW,
    scratchpad_bytes: float = hwdb.SCRATCH_BYTES,
) -> AcceleratorConfig:
    """Split the compute area budget across sub-accelerator classes
    (the AESPA template's DSE parameter, §IV-A)."""
    total = sum(fractions.values())
    clusters = []
    for cls, frac in fractions.items():
        if frac <= 0:
            continue
        pes = hwdb.pes_for_area(cls, hwdb.COMPUTE_MM2 * frac / total)
        if pes > 0:
            clusters.append(basic_cluster(cls, pes))
    return AcceleratorConfig(name, tuple(clusters), hbm_bw, scratchpad_bytes)


#: Baseline display names, keyed the way Fig 10/12/13 label their bars.
BASELINE_CLASSES: Dict[str, DataflowClass] = {
    "homog_tpu": DataflowClass.GEMM,
    "homog_eie": DataflowClass.SPMM,
    "homog_extensor": DataflowClass.SPGEMM_INNER,
    "homog_outerspace": DataflowClass.SPGEMM_OUTER,
    "homog_matraptor": DataflowClass.SPGEMM_GUSTAVSON,
}


def baseline_configs(hbm_bw: float = hwdb.HBM_BW,
                     include_hybrid: bool = True
                     ) -> Dict[str, AcceleratorConfig]:
    """The paper's homogeneous comparison points, each at the FULL compute
    area budget (Fig 1 PE counts): EIE-, TPU-, ExTensor-, OuterSPACE- and
    MatRaptor-like, plus (optionally) the homogeneous-hybrid design. Every
    DSE result reports speedup/EDP ratios against these, the way Fig 10
    and Fig 13 do."""
    out = {name: homogeneous(cls, hbm_bw)
           for name, cls in BASELINE_CLASSES.items()}
    if include_hybrid:
        out["homog_hybrid"] = homogeneous_hybrid(hbm_bw)
    return out


# ------------------------------------------------------- JSON serialization
def cluster_to_json(c: ClusterSpec) -> Dict:
    return {
        "name": c.name,
        "supported": [cls.value for cls in c.supported],
        "pes": c.pes,
        "area_mm2_per_pe": c.area_mm2_per_pe,
        "power_mw_per_pe": c.power_mw_per_pe,
    }


def cluster_from_json(d: Dict) -> ClusterSpec:
    return ClusterSpec(
        name=d["name"],
        supported=tuple(DataflowClass(v) for v in d["supported"]),
        pes=int(d["pes"]),
        area_mm2_per_pe=float(d["area_mm2_per_pe"]),
        power_mw_per_pe=float(d["power_mw_per_pe"]),
    )


def config_to_json(cfg: AcceleratorConfig) -> Dict:
    """JSON-safe dict for an accelerator config (``inf`` bandwidth is
    encoded as the string "inf" so the payload survives strict parsers)."""
    return {
        "name": cfg.name,
        "hbm_bw": "inf" if math.isinf(cfg.hbm_bw) else cfg.hbm_bw,
        "scratchpad_bytes": cfg.scratchpad_bytes,
        "clusters": [cluster_to_json(c) for c in cfg.clusters],
    }


def config_from_json(d: Dict) -> AcceleratorConfig:
    """Inverse of :func:`config_to_json`. Payloads written before the
    scratchpad became a config field (no ``scratchpad_bytes`` key) load at
    the historical 64 MB constant (``hwdb.SCRATCH_BYTES``)."""
    bw = d.get("hbm_bw", hwdb.HBM_BW)
    return AcceleratorConfig(
        name=d["name"],
        clusters=tuple(cluster_from_json(c) for c in d["clusters"]),
        hbm_bw=math.inf if bw == "inf" else float(bw),
        scratchpad_bytes=float(d.get("scratchpad_bytes",
                                     hwdb.SCRATCH_BYTES)),
    )


# ------------------------------------------------------------ primitives
def tripcount(cls: DataflowClass, m: int, k: int, n: int,
              d_mk: float, d_kn: float, mirror: bool = False) -> float:
    """Iterations of the innermost compute loop of the Fig 2 kernel."""
    if cls == DataflowClass.GEMM:
        return float(m) * k * n
    if cls == DataflowClass.SPMM:
        # EIE: loop over the compressed operand's nonzeros × the dense dim.
        d = d_mk if mirror else d_kn
        return float(m) * k * n * d
    # All SpGEMM classes iterate (expected) matching nonzero pairs.
    return float(m) * k * n * d_mk * d_kn


def parallelism_bound(cls: DataflowClass, m: int, k: int, n: int,
                      mirror: bool = False) -> float:
    """Max PEs the workload's dimensions let this class use (Fig 1)."""
    if cls == DataflowClass.GEMM:
        return float(m) * n
    if cls == DataflowClass.SPMM:
        return float(m) if mirror else float(n)   # A-compressed -> M bound
    if cls == DataflowClass.SPGEMM_INNER:
        return float(max(m, n))                   # "M or N"
    if cls == DataflowClass.SPGEMM_OUTER:
        return float(k)                           # K unrolled spatially
    if cls == DataflowClass.SPGEMM_GUSTAVSON:
        return float(n)
    raise ValueError(cls)


def output_density(k: int, d_mk: float, d_kn: float) -> float:
    """Expected output density under uniform random sparsity:
    P[O_mn != 0] = 1 - (1 - d_mk·d_kn)^K."""
    p = d_mk * d_kn
    if p >= 1.0:
        return 1.0
    # stable for tiny p·K
    return float(1.0 - math.exp(k * math.log1p(-p)))


# ------------------------------------------------- reuse-aware traffic
#: Default for the re-streaming traffic model. ``False`` keeps the paper's
#: §VI assumption (compulsory operand bytes only); ``True`` charges extra
#: HBM traffic when a kernel's stationary operand exceeds the 64 MB global
#: scratchpad (ROADMAP "streaming/reuse-aware traffic model").
_REUSE_AWARE_TRAFFIC = False


def set_reuse_aware_traffic(enabled: bool) -> bool:
    """Toggle the process-wide re-streaming traffic model; returns the
    previous value. Clears the scheduler's schedule/placement caches —
    they key on (config, workload) only, not on this flag."""
    global _REUSE_AWARE_TRAFFIC
    prev = _REUSE_AWARE_TRAFFIC
    _REUSE_AWARE_TRAFFIC = bool(enabled)
    if prev != _REUSE_AWARE_TRAFFIC:
        from repro_torch.core import scheduler as _sched  # lazy: circular import
        _sched.clear_schedule_cache()
    return prev


def reuse_aware_traffic() -> bool:
    return _REUSE_AWARE_TRAFFIC


def restream_extra_bytes(cls: DataflowClass, a_bytes, b_bytes, out_bytes,
                         mirror: bool = False,
                         scratch_bytes: Optional[float] = None):
    """Extra HBM traffic beyond compulsory when the stationary operand's
    working set exceeds the global scratchpad.

    Coarse tiling model: the stationary operand R is processed in
    ``ceil(R / scratch_bytes)`` scratchpad-resident tiles and the
    streaming operand S is re-read once per tile —
    ``extra = (ceil(R/scratch) - 1) × S``; zero whenever R fits.
    Stationary/streaming per dataflow: GEMM, inner SpGEMM and Gustavson
    hold B stationary and stream A; SpMM holds its *compressed* operand
    stationary and streams the dense one; the outer product holds the
    output partials stationary and streams both inputs.

    ``scratch_bytes`` is the evaluated design's
    :attr:`AcceleratorConfig.scratchpad_bytes` (``None`` = the historical
    64 MB ``hwdb.SCRATCH_BYTES`` constant). numpy-compatible: every
    argument may be a scalar float or an array — the scheduler's batched
    template eval calls this with fraction-sweep (and candidate-axis)
    arrays."""
    if scratch_bytes is None:
        scratch_bytes = hwdb.SCRATCH_BYTES
    if cls == DataflowClass.SPGEMM_OUTER:
        resident, streaming = out_bytes, a_bytes + b_bytes
    elif cls == DataflowClass.SPMM and mirror:
        resident, streaming = a_bytes, b_bytes
    else:
        resident, streaming = b_bytes, a_bytes
    passes = np.ceil(np.asarray(resident, dtype=float) / scratch_bytes)
    return np.maximum(passes - 1.0, 0.0) * streaming


def operand_components(cls: DataflowClass, m: int, k: int, n: int,
                       d_mk: float, d_kn: float, mirror: bool = False
                       ) -> Tuple[float, float, float]:
    """(a_bytes, b_bytes, out_bytes) of one kernel — the compulsory-traffic
    terms of :func:`operand_bytes`, exposed separately so the batched
    evaluator can feed :func:`restream_extra_bytes` per candidate."""
    def dense(r, c):
        return float(r) * c * WORD

    def compressed(r, c, d, fibers):
        return float(r) * c * d * (WORD + IDX) + fibers * IDX

    if cls == DataflowClass.GEMM:
        a, b = dense(m, k), dense(k, n)
    elif cls == DataflowClass.SPMM:
        if mirror:
            a, b = compressed(m, k, d_mk, m), dense(k, n)
        else:
            a, b = dense(m, k), compressed(k, n, d_kn, n)
    elif cls == DataflowClass.SPGEMM_INNER:
        a, b = compressed(m, k, d_mk, m), compressed(k, n, d_kn, n)
    elif cls == DataflowClass.SPGEMM_OUTER:
        a, b = compressed(m, k, d_mk, k), compressed(k, n, d_kn, k)
    elif cls == DataflowClass.SPGEMM_GUSTAVSON:
        a, b = compressed(m, k, d_mk, k), compressed(k, n, d_kn, n)
    else:
        raise ValueError(cls)
    d_out = output_density(k, d_mk, d_kn)
    if d_out < 0.5:
        out = compressed(m, n, d_out, m)
    else:
        out = dense(m, n)
    return a, b, out


def operand_bytes(cls: DataflowClass, m: int, k: int, n: int,
                  d_mk: float, d_kn: float, mirror: bool = False,
                  reuse_aware: Optional[bool] = None,
                  scratch_bytes: Optional[float] = None) -> float:
    """HBM traffic: operand reads (format-dependent) + output write.

    Outputs of sparse×sparse products stream back compressed (value +
    coordinate per expected nonzero) — the (de)compressor path of §IV-C;
    near-dense outputs write dense. ``reuse_aware`` (default: the
    process-wide :func:`set_reuse_aware_traffic` flag, off) additionally
    charges :func:`restream_extra_bytes` when the stationary operand
    overflows the scratchpad (``scratch_bytes``; ``None`` = the 64 MB
    default — pass the config's :attr:`AcceleratorConfig.scratchpad_bytes`
    so the joint DSE's memory axis reaches the traffic model)."""
    a, b, out = operand_components(cls, m, k, n, d_mk, d_kn, mirror)
    total = a + b + out
    if reuse_aware is None:
        reuse_aware = _REUSE_AWARE_TRAFFIC
    if reuse_aware:
        total += float(restream_extra_bytes(cls, a, b, out, mirror,
                                            scratch_bytes=scratch_bytes))
    return total


@dataclasses.dataclass(frozen=True)
class PartitionCost:
    """Cost of one partition on one cluster."""

    cls: DataflowClass
    cycles: float            # compute cycles on the assigned PEs
    pes_used: float
    bytes_moved: float
    effectual_macs: float
    energy_pj: float         # active-PE energy (diagnostic; totals charge
                             # powered-cluster power × runtime instead)


def partition_cost(cls: DataflowClass, cluster: ClusterSpec,
                   m: int, k: int, n: int, d_mk: float, d_kn: float,
                   mirror: bool = False,
                   pes_override: Optional[int] = None,
                   reuse_aware: Optional[bool] = None,
                   scratch_bytes: Optional[float] = None) -> PartitionCost:
    if m <= 0 or k <= 0 or n <= 0:
        return PartitionCost(cls, 0.0, 0.0, 0.0, 0.0, 0.0)
    pes = cluster.pes if pes_override is None else pes_override
    trips = tripcount(cls, m, k, n, d_mk, d_kn, mirror)
    p_eff = min(float(pes), parallelism_bound(cls, m, k, n, mirror))
    cycles = math.ceil(trips / max(p_eff, 1.0))
    nbytes = operand_bytes(cls, m, k, n, d_mk, d_kn, mirror,
                           reuse_aware=reuse_aware,
                           scratch_bytes=scratch_bytes)
    effectual = float(m) * k * n * d_mk * d_kn
    # pJ: mW/PE × ns == pJ; active PEs for the duration of the partition.
    energy = cluster.power_mw_per_pe * p_eff * cycles
    return PartitionCost(cls, float(cycles), p_eff, nbytes, effectual, energy)


# ------------------------------------------------------------- aggregation
@dataclasses.dataclass(frozen=True)
class KernelReport:
    """Whole-kernel execution estimate on an accelerator config."""

    runtime_s: float
    compute_cycles: float          # critical-path cluster cycles
    mem_s: float
    bytes_moved: float
    energy_pj: float               # compute + data movement
    effectual_macs: float
    effective_utilization: float   # effectual MACs / (all PEs × runtime)
    memory_bound: bool

    @property
    def edp(self) -> float:
        return self.energy_pj * 1e-12 * self.runtime_s  # J·s


def powered_power_mw(config: AcceleratorConfig,
                     per_cluster_cycles: Dict[int, float]) -> float:
    """Total power (mW) of the clusters a schedule actually touches.

    Sub-accelerator clusters are independent blocks (§IV-A), so a cluster
    with no partitions assigned is power-gated for the kernel's duration;
    a *powered* cluster burns its full nameplate power whether its PEs are
    doing effectual work or idling — that is the "utilization" half of the
    paper's §VI energy model (low utilization = paid-for-but-wasted power).
    Homogeneous designs are a single cluster and therefore always pay for
    the whole array.
    """
    return sum(c.power_mw_per_pe * c.pes for i, c in enumerate(config.clusters)
               if per_cluster_cycles.get(i, 0.0) > 0.0)


def aggregate(config: AcceleratorConfig,
              per_cluster_cycles: Dict[int, float],
              parts: Sequence[PartitionCost]) -> KernelReport:
    """Combine partition costs into a kernel report.

    Runtime = max(slowest cluster, HBM transfer time) — compute/memory
    overlap assumed (double-buffered global scratchpad, §IV-B).
    Energy = powered-cluster power × runtime (utilization term, §VI:
    unused clusters are power-gated, powered clusters burn nameplate
    power for the kernel's duration) + switching energy of effectual MACs
    + data movement (paper §VI: "utilization of the accelerator and the
    on-chip data movement").
    """
    compute_cycles = max(per_cluster_cycles.values(), default=0.0)
    compute_s = compute_cycles / hwdb.FREQ_HZ
    total_bytes = sum(p.bytes_moved for p in parts)
    mem_s = 0.0 if math.isinf(config.hbm_bw) else total_bytes / config.hbm_bw
    runtime_s = max(compute_s, mem_s, 1e-12)
    effectual = sum(p.effectual_macs for p in parts)
    runtime_cycles = runtime_s * hwdb.FREQ_HZ
    energy = (
        powered_power_mw(config, per_cluster_cycles) * runtime_cycles
        + total_bytes * (hwdb.E_HBM_PER_BYTE + hwdb.E_SCRATCH_PER_BYTE)
        + effectual * hwdb.E_MAC
    )
    util = effectual / max(config.total_pes * runtime_s * hwdb.FREQ_HZ, 1.0)
    return KernelReport(
        runtime_s=runtime_s,
        compute_cycles=compute_cycles,
        mem_s=mem_s,
        bytes_moved=total_bytes,
        energy_pj=energy,
        effectual_macs=effectual,
        effective_utilization=util,
        memory_bound=mem_s > compute_s,
    )


def geomean(xs: Sequence[float]) -> float:
    """Geometric mean with a 1e-30 floor (sequential ``math.log``
    accumulation, as the JAX package's batched evaluator reproduces it)."""
    xs = [max(x, 1e-30) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


# ----------------------------------------------- batched (joint-space) eval
@dataclasses.dataclass(frozen=True)
class ConfigBatch:
    """Structure-of-arrays batch of ``n`` candidate accelerator designs.

    Candidate ``i`` owns one *basic* cluster per swept dataflow class —
    ``pes[i, j]`` PEs of ``classes[j]`` (0 = the class is absent from that
    design) — plus its own memory system: ``hbm_bw[i]`` bytes/s and
    ``scratchpad_bytes[i]`` bytes. That is exactly the joint DSE design
    vector {area fractions, hbm_bw, scratchpad_bytes}; hybrid
    (multi-class) clusters are out of scope — they never appear in the
    swept space, only in the fixed baseline configs, which keep the
    scalar path.

    Invariant: ``batch.config(i)`` materialises the *same*
    :class:`AcceleratorConfig` (cluster order, PE counts, memory fields)
    that :func:`aespa_from_fractions` builds from the fraction vector —
    :meth:`from_fractions` mirrors its arithmetic operation for operation,
    including ``pes_for_area``'s truncation.
    """

    classes: Tuple[DataflowClass, ...]
    pes: np.ndarray                 # (n, C) int64; 0 = absent cluster
    hbm_bw: np.ndarray              # (n,) float; inf = unlimited
    scratchpad_bytes: np.ndarray    # (n,) float

    @property
    def n(self) -> int:
        return self.pes.shape[0]

    @property
    def feasible(self) -> np.ndarray:
        """(n,) bool: candidate has at least one non-empty cluster (the
        batch twin of :func:`aespa_from_fractions` yielding no clusters)."""
        return (self.pes > 0).any(axis=1)

    @classmethod
    def from_fractions(cls, vecs: Sequence[Sequence[float]],
                       classes: Sequence[DataflowClass],
                       hbm_bw=hwdb.HBM_BW,
                       scratchpad_bytes=hwdb.SCRATCH_BYTES) -> "ConfigBatch":
        """Build a batch from (n, C) area-fraction vectors over ``classes``.

        ``hbm_bw``/``scratchpad_bytes`` may be scalars or (n,) arrays.
        Mirrors :func:`aespa_from_fractions` exactly: fractions are
        normalised by the sum of the *positive* entries, each class gets
        ``int(COMPUTE_MM2 · frac/total / area_per_pe)`` PEs, and a class
        whose share truncates to zero PEs is absent."""
        classes = tuple(classes)
        vecs = np.asarray(vecs, dtype=float)
        if vecs.ndim != 2 or vecs.shape[1] != len(classes):
            raise ValueError(
                f"fraction array of shape {vecs.shape} does not match "
                f"{len(classes)} classes")
        n = vecs.shape[0]
        # Ordered accumulation (class order, positives only) == the scalar
        # sum(fractions.values()); adding 0.0 for skipped entries is exact.
        total = np.zeros(n)
        for j in range(len(classes)):
            total += np.where(vecs[:, j] > 0.0, vecs[:, j], 0.0)
        safe_total = np.where(total > 0.0, total, 1.0)
        pes = np.zeros((n, len(classes)), dtype=np.int64)
        for j, c in enumerate(classes):
            per_pe = hwdb.PROFILES[c].area_mm2_per_pe
            area = hwdb.COMPUTE_MM2 * vecs[:, j] / safe_total
            cnt = np.floor(area / per_pe)   # == pes_for_area's int() (>0)
            pes[:, j] = np.where(vecs[:, j] > 0.0, cnt, 0.0).astype(np.int64)
        bw = np.broadcast_to(np.asarray(hbm_bw, dtype=float), (n,)).copy()
        scratch = np.broadcast_to(
            np.asarray(scratchpad_bytes, dtype=float), (n,)).copy()
        return cls(classes, pes, bw, scratch)

    def config(self, i: int, name: str = "aespa_dse") -> AcceleratorConfig:
        """Materialise candidate ``i`` as a scalar-path config."""
        clusters = tuple(
            basic_cluster(c, int(self.pes[i, j]))
            for j, c in enumerate(self.classes) if self.pes[i, j] > 0)
        return AcceleratorConfig(name, clusters, float(self.hbm_bw[i]),
                                 float(self.scratchpad_bytes[i]))


@dataclasses.dataclass(frozen=True)
class SuiteEvalBatch:
    """Per-candidate geomean suite metrics — the (n,) array twin of
    ``repro_torch.core.dse.SuiteEval``. Infeasible candidates score ``inf``."""

    geomean_runtime_s: np.ndarray
    geomean_energy_pj: np.ndarray
    geomean_edp: np.ndarray

    @property
    def n(self) -> int:
        return self.geomean_runtime_s.shape[0]

    def objective(self, name: str) -> np.ndarray:
        if name == "edp":
            return self.geomean_edp
        if name == "runtime":
            return self.geomean_runtime_s
        if name == "energy":
            return self.geomean_energy_pj
        raise ValueError(f"unknown objective {name!r}; "
                         "one of ('edp', 'runtime', 'energy')")


#: Candidate-axis chunk of the batched suite evaluation: bounds the
#: (chunk, templates) intermediates to a few MB regardless of sweep size.
_EVAL_CHUNK = 1024


def evaluate_config_batch(batch: ConfigBatch,
                          suite: Sequence,
                          fracs: Optional[Sequence[float]] = None,
                          refine: bool = False) -> SuiteEvalBatch:
    """Score every candidate of ``batch`` against a workload suite in one
    numpy pass — the joint-DSE evaluator.

    Bit-matches the scalar path: for every feasible candidate ``i``,
    ``evaluate_config_batch(batch, suite)`` equals
    ``dse.evaluate_config(batch.config(i), suite)`` exactly (same floats,
    not approximately) — the per-candidate schedule search
    (:func:`repro_torch.core.scheduler.batch_single_kernel_eval`) replicates the
    scalar scheduler's arithmetic and tie-breaking operation for
    operation, and the geomeans accumulate with scalar ``math`` calls in
    suite order. Infeasible candidates (no clusters) come back ``inf``.
    """
    from repro_torch.core import scheduler as _sched  # lazy: circular import

    if fracs is None:
        fracs = _sched._FRACS
    fracs = tuple(fracs)
    n = batch.n
    out_rt = np.empty(n)
    out_en = np.empty(n)
    out_edp = np.empty(n)
    for lo in range(0, n, _EVAL_CHUNK):
        hi = min(lo + _EVAL_CHUNK, n)
        sub = ConfigBatch(batch.classes, batch.pes[lo:hi],
                          batch.hbm_bw[lo:hi], batch.scratchpad_bytes[lo:hi])
        runtimes: List[np.ndarray] = []
        energies: List[np.ndarray] = []
        for w in suite:
            rt, en = _sched.batch_single_kernel_eval(sub, w, fracs=fracs,
                                                     refine=refine)
            runtimes.append(rt)
            energies.append(en)
        # KernelReport.edp == energy_pj * 1e-12 * runtime_s, same order.
        edps = [en * 1e-12 * rt for rt, en in zip(runtimes, energies)]
        for i in range(hi - lo):
            out_rt[lo + i] = geomean([float(r[i]) for r in runtimes])
            out_en[lo + i] = geomean([float(e[i]) for e in energies])
            out_edp[lo + i] = geomean([float(e[i]) for e in edps])
    return SuiteEvalBatch(out_rt, out_en, out_edp)


# --------------------------------------------------------------------------
# Software-kernel cost: the achieved-intensity hook of the executor's
# ``cost_sink`` (``ops.op_cost``). The hardware model above predicts the
# paper's accelerator; this section models one kernel call:
#
# * ``flops``/``bytes`` — the algorithmic work and HBM traffic of the
#   sparsity-proportional formulation (FLOPs ∝ nnz). ``intensity`` is their
#   ratio: the roofline x-coordinate the kernel should sit at.
# * ``mac_eq`` — a time proxy in dense-MAC equivalents, built from
#   per-element weights of the four primitive operations the kernel bodies
#   are composed of.
# --------------------------------------------------------------------------

#: The JAX package's per-element weights, fitted to its Pallas kernels in
#: interpret mode on a CPU (dense MAC the unit, gather+batched-dot,
#: scatter-add, one-hot expansion). Kept unchanged so both packages report
#: the same costs; they say nothing about the CUDA kernels' times on the
#: card (refitting them from H100 rows is ROADMAP.md work).
W_MAC = 1.0
W_GATHER = 30.0
W_SCATTER = 5000.0
W_EXPAND = 500.0


@dataclasses.dataclass(frozen=True)
class SwKernelCost:
    """Modelled cost of one kernel invocation (not the paper HW)."""

    kind: str                 # "gemm" | "spmm" | "inner" | "outer" | "gustavson"
    method: str               # resolved body: "dense" | "sparse" | "reference"
    flops: float              # useful (sparsity-proportional) FLOPs
    bytes: float              # modelled HBM traffic
    mac_eq: float             # time proxy, dense-MAC units

    @property
    def intensity(self) -> float:
        """Roofline x-coordinate: useful FLOPs per modelled HBM byte."""
        return self.flops / max(self.bytes, 1.0)


def sw_kernel_cost(
    kind: str, m: int, k: int, n: int, *,
    nnz_a: Optional[float] = None, nnz_b: Optional[float] = None,
    cap_a: Optional[int] = None, cap_b: Optional[int] = None,
    method: str = "auto", bm: int = 128, bn: int = 128,
) -> SwKernelCost:
    """Model one kernel call. ``nnz_*`` are true nonzero counts (host
    floats are fine); ``cap_*`` the static ELL capacities, used only to
    resolve ``method="auto"`` with the same thresholds the kernel entry
    points apply (kernels/{spmm,spgemm_*}.py — keep in sync)."""
    ell = WORD + IDX                       # bytes per live compressed entry
    mkn = float(m) * k * n
    out_b = WORD * float(m) * n
    if kind == "gemm":
        return SwKernelCost("gemm", "dense", 2.0 * mkn,
                            WORD * float(m * k + k * n) + out_b, mkn)

    na = float(nnz_a if nnz_a is not None else m * k)
    nb = float(nnz_b if nnz_b is not None else k * n)
    # Per-tile expansion burden of the reference bodies: every (bm, bn)
    # output tile re-expands its operand fibers across the full minor dim.
    ref_expand = W_EXPAND * mkn * (1.0 / bm + 1.0 / bn)

    if kind == "spmm":
        if method == "auto":
            method = "sparse" if cap_b is not None and 2 * cap_b <= k else "reference"
        flops = 2.0 * m * nb
        if method == "sparse":
            return SwKernelCost(kind, method, flops,
                                WORD * float(m) * k + ell * nb + out_b,
                                mkn + W_SCATTER * nb)
        return SwKernelCost(kind, method, flops,
                            WORD * float(m) * k + ell * nb * (m // bm) + out_b,
                            mkn + W_EXPAND * (m // bm) * float(k) * n)

    if kind == "inner":
        if method == "auto":
            method = "sparse" if cap_a is not None and 4 * cap_a <= k else "reference"
        flops = 2.0 * na * n
        if method == "sparse":
            return SwKernelCost(kind, method, flops,
                                ell * (na * (n // bn) + nb) + out_b,
                                W_GATHER * na * n + W_SCATTER * nb)
        return SwKernelCost(kind, method, flops,
                            ell * (na * (n // bn) + nb * (m // bm)) + out_b,
                            mkn + ref_expand)

    if kind == "outer":
        if method == "auto":
            from repro_torch.kernels.spgemm_outer import OUTER_TABLE_BYTES_MAX
            fits = 4 * k * (m + n) <= OUTER_TABLE_BYTES_MAX
            method = "sparse" if fits else "reference"
        flops = 2.0 * na * nb / max(k, 1)
        if method == "sparse":
            return SwKernelCost(kind, method, flops, ell * (na + nb) + out_b,
                                mkn + W_SCATTER * (na + nb))
        return SwKernelCost(kind, method, flops,
                            ell * (na + nb) * (m // bm) * (n // bn) + out_b,
                            mkn + ref_expand)

    if kind == "gustavson":
        if method == "auto":
            method = "sparse" if cap_b is not None and 4 * cap_b <= k else "reference"
        flops = 2.0 * na * nb / max(k, 1)
        if method == "sparse":
            return SwKernelCost(kind, method, flops,
                                ell * (na * (m // bm) + nb) + out_b,
                                W_GATHER * nb * m + W_SCATTER * na * (m // bm))
        return SwKernelCost(kind, method, flops,
                            ell * (na + nb) * (m // bm) * (n // bn) + out_b,
                            mkn + ref_expand)

    raise ValueError(f"unknown sw kernel kind: {kind!r}")


#: DataflowClass -> sw_kernel_cost kind (the executor's cost-sink hook).
SW_KIND = {
    DataflowClass.GEMM: "gemm",
    DataflowClass.SPMM: "spmm",
    DataflowClass.SPGEMM_INNER: "inner",
    DataflowClass.SPGEMM_OUTER: "outer",
    DataflowClass.SPGEMM_GUSTAVSON: "gustavson",
}


# -------------------------------------------------------------- queueing
@dataclasses.dataclass(frozen=True)
class QueueStats:
    """Multi-tenant queueing/utilization aggregates of a many-kernel
    schedule (paper §V-B, Fig 12): how busy each cluster's queue kept it
    over the makespan, how long tasks waited past their arrival (with tail
    percentiles), live queue depth, and deadline accounting when the caller
    supplies deadlines. The fields are the JAX package's, so the two
    serialise to the same ``to_json``."""

    busy_cycles: Tuple[float, ...]       # per cluster, Σ assigned cycles
    busy_fraction: Tuple[float, ...]     # busy_cycles / makespan
    utilization: float                   # PE-weighted mean busy fraction
    mean_wait_cycles: float              # mean(start - arrival) over tasks
    max_wait_cycles: float
    mean_turnaround_cycles: float        # mean(finish - arrival) over tasks
    #: Clusters run their queues concurrently, so the schedule drains in
    #: ``concurrent_makespan_cycles`` (max over cluster finish times);
    #: serialising every cluster queue onto one device takes
    #: ``sequential_makespan_cycles`` (Σ busy cycles over clusters).
    concurrent_makespan_cycles: float = 0.0
    sequential_makespan_cycles: float = 0.0
    n_tasks: int = 0
    p50_wait_cycles: float = 0.0
    p90_wait_cycles: float = 0.0
    p99_wait_cycles: float = 0.0
    p50_turnaround_cycles: float = 0.0
    p99_turnaround_cycles: float = 0.0
    queue_depth: int = 0                 # offered-not-started at snapshot
    deadline_total: int = 0              # tasks that carried a deadline
    deadline_misses: int = 0             # finish > deadline among those
    worst_lateness_cycles: float = 0.0   # max(finish - deadline, 0)
    #: Measured twin of the concurrency pair, filled by an executor that
    #: times each cluster's span (the stream executor, not ported yet);
    #: empty/zero when the run was not measured.
    measured_busy_s: Tuple[float, ...] = ()     # per cluster, Σ span busy
    measured_makespan_s: float = 0.0            # wall first-dispatch→last-done
    measured_sequential_s: float = 0.0          # Σ measured_busy_s

    @property
    def spatial_speedup(self) -> float:
        """Sequential / concurrent makespan: the speedup spatial cluster
        concurrency buys over one-device serialisation."""
        return (self.sequential_makespan_cycles
                / max(self.concurrent_makespan_cycles, 1e-12))

    @property
    def measured_spatial_speedup(self) -> float:
        """Observed sequential / observed wall makespan; 0.0 when the run
        carried no measurements."""
        if self.measured_makespan_s <= 0.0:
            return 0.0
        return self.measured_sequential_s / self.measured_makespan_s

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["spatial_speedup"] = self.spatial_speedup
        d["measured_spatial_speedup"] = self.measured_spatial_speedup
        return d


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method), 0.0 on an
    empty sequence. ``q`` in [0, 100]."""
    if not xs:
        return 0.0
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def cycles_to_us(cycles: float) -> float:
    """Modelled cycles → microseconds at ``hwdb.FREQ_HZ`` (1 GHz ⇒ 1000
    cycles = 1 µs)."""
    return float(cycles) / (hwdb.FREQ_HZ / 1e6)


def queue_stats(config: AcceleratorConfig,
                busy_cycles: Sequence[float],
                wait_cycles: Sequence[float],
                turnaround_cycles: Sequence[float],
                makespan_cycles: float,
                *,
                queue_depth: int = 0,
                finish_cycles: Optional[Sequence[float]] = None,
                deadline_cycles: Optional[Sequence[Optional[float]]] = None,
                ) -> QueueStats:
    """Aggregate per-cluster busy time and per-task waits into the
    utilization report attached to every many-kernel schedule.

    ``finish_cycles``/``deadline_cycles`` (parallel sequences; deadline
    entries may be ``None`` for best-effort tasks) enable the deadline
    fields."""
    span = max(makespan_cycles, 1e-12)
    frac = tuple(b / span for b in busy_cycles)
    total_pes = max(sum(c.pes for c in config.clusters), 1)
    util = sum(f * c.pes for f, c in zip(frac, config.clusters)) / total_pes
    n = max(len(wait_cycles), 1)
    deadline_total = deadline_misses = 0
    worst_late = 0.0
    if deadline_cycles is not None:
        if finish_cycles is None or len(finish_cycles) != len(deadline_cycles):
            raise ValueError(
                "deadline accounting needs finish_cycles parallel to "
                "deadline_cycles")
        for fin, dl in zip(finish_cycles, deadline_cycles):
            if dl is None:
                continue
            deadline_total += 1
            late = fin - dl
            if late > 1e-9:
                deadline_misses += 1
                worst_late = max(worst_late, late)
    return QueueStats(
        busy_cycles=tuple(float(b) for b in busy_cycles),
        busy_fraction=frac,
        utilization=util,
        mean_wait_cycles=sum(wait_cycles) / n,
        max_wait_cycles=max(wait_cycles, default=0.0),
        mean_turnaround_cycles=sum(turnaround_cycles) / n,
        concurrent_makespan_cycles=float(makespan_cycles),
        sequential_makespan_cycles=float(sum(busy_cycles)),
        n_tasks=len(wait_cycles),
        p50_wait_cycles=percentile(wait_cycles, 50.0),
        p90_wait_cycles=percentile(wait_cycles, 90.0),
        p99_wait_cycles=percentile(wait_cycles, 99.0),
        p50_turnaround_cycles=percentile(turnaround_cycles, 50.0),
        p99_turnaround_cycles=percentile(turnaround_cycles, 99.0),
        queue_depth=int(queue_depth),
        deadline_total=deadline_total,
        deadline_misses=deadline_misses,
        worst_lateness_cycles=worst_late,
    )


def merge_queue_stats(replica_busy: Sequence[Tuple[AcceleratorConfig,
                                                   Sequence[float]]],
                      wait_cycles: Sequence[float],
                      turnaround_cycles: Sequence[float],
                      makespan_cycles: float,
                      *,
                      queue_depth: int = 0,
                      finish_cycles: Optional[Sequence[float]] = None,
                      deadline_cycles: Optional[
                          Sequence[Optional[float]]] = None,
                      ) -> QueueStats:
    """Fleet-level :class:`QueueStats` over several serving replicas.

    ``replica_busy`` is one ``(config, per-cluster busy cycles)`` pair per
    replica; the clusters are concatenated into one synthetic fleet-wide
    config so utilization is PE-weighted over the *union* of all replicas'
    clusters against the shared fleet makespan (a dead replica's retired
    busy time still counts — the PEs existed while they worked). Waits,
    turnarounds and deadlines are the usual per-request ladders, passed
    across the whole fleet. Used by ``repro_torch.launch.fleet`` for
    the aggregate report."""
    if not replica_busy:
        raise ValueError("merge_queue_stats needs at least one replica")
    clusters: List[ClusterSpec] = []
    busy: List[float] = []
    for cfg, b in replica_busy:
        if len(b) != len(cfg.clusters):
            raise ValueError(
                f"{len(b)} busy entries for {len(cfg.clusters)} clusters "
                f"of {cfg.name}")
        clusters.extend(cfg.clusters)
        busy.extend(float(x) for x in b)
    fleet_cfg = AcceleratorConfig(
        f"fleet[{len(replica_busy)}x{replica_busy[0][0].name}]",
        tuple(clusters), hbm_bw=replica_busy[0][0].hbm_bw,
        scratchpad_bytes=replica_busy[0][0].scratchpad_bytes)
    return queue_stats(fleet_cfg, busy, wait_cycles, turnaround_cycles,
                       makespan_cycles, queue_depth=queue_depth,
                       finish_cycles=finish_cycles,
                       deadline_cycles=deadline_cycles)
