"""Design-space exploration over the AESPA template (paper §IV-A, §VII,
Fig 13), copied from ``repro.core.dse`` so the port carries no dependency
on the JAX package; it is numpy throughout and runs on the host.

* :func:`search` — the best point of the joint design space {area
  fractions, hbm_bw, scratchpad_bytes} for a workload suite under
  single-kernel scheduling: a coarse proposal sweep (the fraction simplex
  × the memory grids) scored as one batched numpy pass
  (:func:`repro_torch.core.costmodel.evaluate_config_batch`, bit-equal to
  the scalar :func:`evaluate_config`), then cost-ranked local refinement
  around the incumbent until no proposal improves.
* :func:`compare_to_baselines` — speedup/energy/EDP ratios against the
  paper's homogeneous designs at the full area budget.
* :func:`co_search` — design × policy co-DSE: the best (design,
  scheduling policy) pair for a *traffic* of kernels, offline (whole-queue
  makespan) and online (staggered arrivals, queueing stats), under
  ``schedule_many_kernels`` across the registered policies; serving
  (``repro_torch.serve.cluster.deploy_from_dse``) is its user.
* :func:`aespa_opt` — the paper's "high performance configuration
  searched by our model", the design whose Gustavson partitions run on
  the card through ``kernels/spgemm_gustavson``.

The search counts its evaluations and incumbent improvements
(``dse.evaluations``, ``dse.incumbent_improved``) in ``repro_torch.obs``
and, while tracing is on, records them on the host timeline, as the JAX
package does.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.core import hwdb
from repro_torch.core import scheduler as _sched
from repro_torch.core.workloads import TABLE_I, Workload
from repro_torch.formats.taxonomy import DataflowClass
from repro_torch.obs import trace as _trace_mod

# DSE progress metrics: total candidate evaluations (batched passes inc
# by batch size) and incumbent improvements; the tracer mirrors them as
# a counter track / instant events on the host timeline while enabled.
_MET_EVALS = _obs.METRICS.counter("dse.evaluations")
_MET_IMPROVED = _obs.METRICS.counter("dse.incumbent_improved")

CLASSES = tuple(DataflowClass)

#: Default scheduler fraction grids (re-exported for callers building
#: custom evaluations).
SCHED_FRACS = _sched._FRACS

_OBJECTIVES = ("edp", "runtime", "energy")

#: Geometric mean with a 1e-30 floor. Lives in ``costmodel`` so the
#: batched evaluator shares the exact (bit-for-bit) accumulation.
geomean = cm.geomean


def _deprecate_max_workers() -> None:
    warnings.warn(
        "max_workers= is deprecated and ignored: the DSE scores every "
        "candidate in one vectorized numpy pass "
        "(costmodel.evaluate_config_batch); the thread pool is gone.",
        DeprecationWarning, stacklevel=3)


# ------------------------------------------------------------- evaluation
@dataclasses.dataclass(frozen=True)
class SuiteEval:
    """Geomean suite metrics of one config under single-kernel scheduling."""

    geomean_runtime_s: float
    geomean_energy_pj: float
    geomean_edp: float

    def objective(self, name: str) -> float:
        if name == "edp":
            return self.geomean_edp
        if name == "runtime":
            return self.geomean_runtime_s
        if name == "energy":
            return self.geomean_energy_pj
        raise ValueError(f"unknown objective {name!r}; one of {_OBJECTIVES}")


def evaluate_suite(config: cm.AcceleratorConfig,
                   suite: Sequence[Workload] = TABLE_I,
                   fracs: Sequence[float] = SCHED_FRACS,
                   refine: bool = False) -> SuiteEval:
    """Geomean (runtime, energy, EDP) of the suite under single-kernel
    scheduling. Per-``(config, workload)`` schedules are memoized, so
    re-evaluating a config (the refinement stage revisits neighbours)
    costs dict lookups."""
    runtimes, energies, edps = [], [], []
    for w in suite:
        s = _sched.schedule_single_kernel(config, w, fracs=fracs,
                                          refine=refine, memo=True)
        runtimes.append(s.report.runtime_s)
        energies.append(s.report.energy_pj)
        edps.append(s.report.edp)
    return SuiteEval(geomean(runtimes), geomean(energies), geomean(edps))


def evaluate_config(config: cm.AcceleratorConfig,
                    suite: Sequence[Workload] = TABLE_I,
                    fracs: Sequence[float] = SCHED_FRACS,
                    refine: bool = False) -> Tuple[float, float]:
    """(geomean runtime, geomean EDP); :func:`evaluate_suite` also
    reports energy."""
    ev = evaluate_suite(config, suite, fracs=fracs, refine=refine)
    return ev.geomean_runtime_s, ev.geomean_edp


# ------------------------------------------------------------ the simplex
def _simplex_steps(step: float) -> int:
    """Validate ``step`` and return the number of simplex divisions.

    The sweep enumerates integer lattice points of the simplex, so ``step``
    must divide 1 exactly — a step of 0.3 cannot be honoured and would
    silently sweep thirds instead. Fail loudly rather than misreport the
    granularity the caller asked for."""
    if not (0.0 < step <= 1.0):
        raise ValueError(f"step must be in (0, 1], got {step}")
    n = round(1.0 / step)
    if abs(n * step - 1.0) > 1e-9:
        raise ValueError(
            f"step={step} does not divide 1: the simplex sweep would "
            f"silently use 1/{n} ≈ {1.0 / n:.4f} instead. Pass a step of "
            "the form 1/k (e.g. 0.5, 0.25, 0.2, 0.125).")
    return n


def _simplex(step: float, dims: int):
    """All fraction vectors over ``dims`` classes summing to 1."""
    n = _simplex_steps(step)
    for combo in itertools.product(range(n + 1), repeat=dims):
        if sum(combo) == n:
            yield tuple(c / n for c in combo)


# --------------------------------------------------------------- results
@dataclasses.dataclass(frozen=True)
class DsePoint:
    """One evaluated candidate of a search sweep: a joint design vector
    (area fractions + memory provisioning) and its suite metrics."""

    fractions: Tuple[Tuple[DataflowClass, float], ...]
    area_mm2: float
    eval: SuiteEval
    hbm_bw: float = hwdb.HBM_BW
    scratchpad_bytes: float = hwdb.SCRATCH_BYTES

    @property
    def fractions_dict(self) -> Dict[DataflowClass, float]:
        return dict(self.fractions)

    def to_json(self) -> Dict:
        return {
            "fractions": {c.value: f for c, f in self.fractions},
            "area_mm2": self.area_mm2,
            "hbm_bw": "inf" if math.isinf(self.hbm_bw) else self.hbm_bw,
            "scratchpad_bytes": self.scratchpad_bytes,
            "geomean_runtime_s": self.eval.geomean_runtime_s,
            "geomean_energy_pj": self.eval.geomean_energy_pj,
            "geomean_edp": self.eval.geomean_edp,
        }


@dataclasses.dataclass(frozen=True)
class BaselineRatios:
    """This-design-over-baseline improvement factors (>1 = we win)."""

    speedup: float
    energy_ratio: float
    edp_ratio: float

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DseResult:
    config: cm.AcceleratorConfig
    fractions: Dict[DataflowClass, float]
    geomean_runtime_s: float
    geomean_edp: float
    geomean_energy_pj: float = 0.0
    objective: str = "edp"
    evaluations: int = 0
    wall_time_s: float = 0.0
    baselines: Dict[str, BaselineRatios] = dataclasses.field(
        default_factory=dict)
    pareto: Tuple[DsePoint, ...] = ()

    def to_json(self) -> Dict:
        return {
            "config": cm.config_to_json(self.config),
            "fractions": {c.value: f for c, f in self.fractions.items()},
            "geomean_runtime_s": self.geomean_runtime_s,
            "geomean_energy_pj": self.geomean_energy_pj,
            "geomean_edp": self.geomean_edp,
            "objective": self.objective,
            "evaluations": self.evaluations,
            "wall_time_s": self.wall_time_s,
            "baselines": {k: v.to_json() for k, v in self.baselines.items()},
            "pareto": [p.to_json() for p in self.pareto],
        }


def pareto_front(points: Sequence[DsePoint]) -> Tuple[DsePoint, ...]:
    """Non-dominated subset over (runtime, energy, area, memory
    provisioning), sorted by runtime. Memory provisioning is a cost axis —
    a design that needs less HBM bandwidth or a smaller scratchpad for the
    same runtime/energy/area dominates. A point is dominated if another is
    no worse on every axis and strictly better on one."""
    def key(p: DsePoint):
        return (p.eval.geomean_runtime_s, p.eval.geomean_energy_pj,
                p.area_mm2, p.hbm_bw, p.scratchpad_bytes)

    front: List[DsePoint] = []
    for p in sorted(points, key=key):
        kp = key(p)
        dominated = False
        for q in front:
            kq = key(q)
            if all(a <= b for a, b in zip(kq, kp)) and kq != kp:
                dominated = True
                break
        if not dominated:
            front.append(p)
    return tuple(front)


def compare_to_baselines(
    eval_: SuiteEval,
    suite: Sequence[Workload] = TABLE_I,
    hbm_bw: Optional[float] = None,
    fracs: Sequence[float] = SCHED_FRACS,
    refine: bool = False,
) -> Dict[str, BaselineRatios]:
    """Fig 10/13-style improvement factors of ``eval_`` over every
    homogeneous baseline at the full area budget."""
    hbm_bw = hwdb.HBM_BW if hbm_bw is None else hbm_bw
    out = {}
    for name, config in cm.baseline_configs(hbm_bw).items():
        b = evaluate_suite(config, suite, fracs=fracs, refine=refine)
        out[name] = BaselineRatios(
            speedup=b.geomean_runtime_s / eval_.geomean_runtime_s,
            energy_ratio=b.geomean_energy_pj / eval_.geomean_energy_pj,
            edp_ratio=b.geomean_edp / eval_.geomean_edp,
        )
    return out


# ---------------------------------------------------------------- search
def _config_for(vec: Tuple[float, ...],
                classes: Tuple[DataflowClass, ...],
                hbm_bw: float,
                scratchpad_bytes: float = hwdb.SCRATCH_BYTES,
                ) -> Optional[Tuple[Dict, cm.AcceleratorConfig]]:
    fractions = {c: f for c, f in zip(classes, vec) if f > 0}
    if not fractions:
        return None
    config = cm.aespa_from_fractions(fractions, name="aespa_dse",
                                     hbm_bw=hbm_bw,
                                     scratchpad_bytes=scratchpad_bytes)
    if not config.clusters:
        return None
    return fractions, config


def _refine_neighbours(vec: Tuple[float, ...], delta: float):
    """±delta transfers between every ordered class pair, clipped to the
    simplex (donor must hold at least ``delta``)."""
    dims = len(vec)
    for i in range(dims):
        if vec[i] < delta - 1e-12:
            continue
        for j in range(dims):
            if i == j:
                continue
            cand = list(vec)
            cand[i] = round(cand[i] - delta, 12)
            cand[j] = round(cand[j] + delta, 12)
            yield tuple(cand)


def _grid_neighbours(value: float, grid: Tuple[float, ...]) -> List[float]:
    """Single-notch moves along a memory grid: the entries adjacent to
    ``value`` in the sorted grid. Empty for a singleton grid, which is how
    a fractions-only search makes no memory move."""
    g = sorted(grid)
    i = g.index(value)
    out: List[float] = []
    if i > 0:
        out.append(g[i - 1])
    if i + 1 < len(g):
        out.append(g[i + 1])
    return out


def _memory_grids(hbm_bw: float,
                  hbm_bw_grid: Optional[Sequence[float]],
                  scratchpad_grid: Optional[Sequence[float]],
                  ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Resolve the joint-space memory axes. ``None`` means "not swept":
    a singleton grid pinning the axis at the scalar default."""
    bw_grid = (tuple(float(b) for b in hbm_bw_grid)
               if hbm_bw_grid is not None else (float(hbm_bw),))
    scratch_grid = (tuple(float(s) for s in scratchpad_grid)
                    if scratchpad_grid is not None
                    else (float(hwdb.SCRATCH_BYTES),))
    if not bw_grid or not scratch_grid:
        raise ValueError("memory grids must be non-empty (pass None to pin "
                         "an axis at its default)")
    if any(b <= 0 for b in bw_grid if not math.isinf(b)) \
            or any(s <= 0 for s in scratch_grid):
        raise ValueError("memory grid entries must be positive")
    return bw_grid, scratch_grid


def search(
    suite: Sequence[Workload] = TABLE_I,
    hbm_bw: Optional[float] = None,
    step: float = 0.25,
    classes: Tuple[DataflowClass, ...] = CLASSES,
    objective: str = "edp",
    verbose: bool = False,
    fracs: Sequence[float] = SCHED_FRACS,
    refine: bool = False,
    refine_fractions: bool = True,
    max_workers: Optional[int] = None,
    with_baselines: bool = False,
    with_pareto: bool = False,
    hbm_bw_grid: Optional[Sequence[float]] = None,
    scratchpad_grid: Optional[Sequence[float]] = None,
) -> DseResult:
    """Two-stage search over the joint design space; returns the best
    config.

    The design vector is {area fractions over ``classes``, hbm_bw,
    scratchpad_bytes}. Stage 1 scores every coarse candidate — the full
    fraction simplex at ``step`` granularity crossed with ``hbm_bw_grid``
    × ``scratchpad_grid`` — in chunked vectorized numpy passes
    (:func:`repro_torch.core.costmodel.evaluate_config_batch`, bit-equal
    to the scalar evaluator). Stage 2 (``refine_fractions``) hill-climbs around
    the incumbent: ±``step/2`` transfers between class pairs plus
    single-notch moves along each memory grid, repeated until no move
    improves. Leaving both grids at ``None`` pins the memory axes at
    ``hbm_bw`` / the hwdb scratchpad default.

    ``fracs``/``refine`` are forwarded to the single-kernel scheduler for
    every candidate evaluation (``refine=True`` enables the scheduler's
    fine fraction grid). ``objective`` is one of ``edp`` / ``runtime`` /
    ``energy``. ``with_baselines`` attaches Fig 10/13-style ratios versus
    the homogeneous baselines; ``with_pareto`` attaches the non-dominated
    front of every point the search evaluated. ``verbose`` prints the
    incumbent after each stage. ``max_workers`` is deprecated and ignored
    (kept so calls written for ``repro`` bind the same parameters).

    Raises :class:`ValueError` when ``step`` does not divide 1, a memory
    grid is empty or non-positive, or the sweep has no feasible candidate
    (empty ``classes``, or an area budget too small for a single PE of
    any class).
    """
    if objective not in _OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; one of {_OBJECTIVES}")
    _simplex_steps(step)  # validate before any work
    if max_workers is not None:
        _deprecate_max_workers()
    hbm_bw = hwdb.HBM_BW if hbm_bw is None else hbm_bw
    bw_grid, scratch_grid = _memory_grids(hbm_bw, hbm_bw_grid,
                                          scratchpad_grid)
    fracs = tuple(fracs)
    t0 = time.perf_counter()

    # Candidate key: (fraction vector, hbm_bw, scratchpad_bytes).
    Key = Tuple[Tuple[float, ...], float, float]
    seen: Dict[Key, Optional[DsePoint]] = {}

    def eval_all(keys: Sequence[Key]) -> List[Optional[DsePoint]]:
        todo = [k for k in keys if k not in seen]
        if todo:
            _MET_EVALS.inc(len(todo))
            t_batch = time.perf_counter()
            vecs = np.asarray([k[0] for k in todo], dtype=np.float64)
            batch = cm.ConfigBatch.from_fractions(
                vecs, classes,
                hbm_bw=np.asarray([k[1] for k in todo]),
                scratchpad_bytes=np.asarray([k[2] for k in todo]))
            ev = cm.evaluate_config_batch(batch, suite, fracs=fracs,
                                          refine=refine)
            # Die area per candidate, accumulated in cluster (= class)
            # order so it bit-matches AcceleratorConfig.area_mm2.
            areas = np.zeros(len(todo))
            for j, c in enumerate(batch.classes):
                per_pe = hwdb.PROFILES[c].area_mm2_per_pe
                areas += np.where(batch.pes[:, j] > 0,
                                  batch.pes[:, j].astype(np.float64) * per_pe,
                                  0.0)
            for i, k in enumerate(todo):
                if not batch.feasible[i]:
                    seen[k] = None
                    continue
                fractions = tuple((c, f) for c, f in zip(classes, k[0])
                                  if f > 0)
                seen[k] = DsePoint(
                    fractions, float(areas[i]),
                    SuiteEval(float(ev.geomean_runtime_s[i]),
                              float(ev.geomean_energy_pj[i]),
                              float(ev.geomean_edp[i])),
                    hbm_bw=float(batch.hbm_bw[i]),
                    scratchpad_bytes=float(batch.scratchpad_bytes[i]))
            if _trace_mod.ENABLED:
                dt = max(time.perf_counter() - t_batch, 1e-9)
                tr = _trace_mod.TRACE
                tr.complete("eval_batch", tr.ts_from_perf(t_batch),
                            dt * 1e6, pid=_trace_mod.PID_HOST, tid="dse",
                            cat="dse", candidates=len(todo))
                tr.counter("dse_evals", pid=_trace_mod.PID_HOST, tid="dse",
                           total=float(_MET_EVALS.value),
                           evals_per_sec=len(todo) / dt)
        return [seen[k] for k in keys]

    # Stage 1: coarse proposal sweep — simplex × memory grids, evaluated
    # as one batched pass.
    if not classes:
        raise ValueError("search over an empty class tuple: nothing to sweep")
    coarse = [(vec, bw, sc)
              for vec in _simplex(step, len(classes))
              for bw in bw_grid
              for sc in scratch_grid]
    points = [p for p in eval_all(coarse) if p is not None]
    if not points:
        raise ValueError(
            f"simplex sweep over {[c.value for c in classes]} at step "
            f"{step} produced no feasible config — every fraction vector "
            "mapped to zero clusters (area budget too small for one PE of "
            "any swept class)")

    def obj(p: DsePoint) -> float:
        return p.eval.objective(objective)

    best_key = min(seen, key=lambda k: obj(seen[k]) if seen[k] else math.inf)
    best = seen[best_key]
    _MET_IMPROVED.inc()
    if _trace_mod.ENABLED:
        _trace_mod.TRACE.instant(
            "incumbent_improved", pid=_trace_mod.PID_HOST, tid="dse",
            cat="dse", stage="coarse", objective=objective,
            score=obj(best), fractions=dict(
                (c.value, f) for c, f in best.fractions))
    if verbose:
        print(f"DSE coarse best: {dict(best.fractions)} "
              f"bw={best.hbm_bw:.3g} scratch={best.scratchpad_bytes:.3g} "
              f"-> {objective}={obj(best):.3e}")

    # Stage 2: cost-ranked local refinement until converged — half-step
    # fraction transfers, then one-notch moves per memory axis.
    if refine_fractions:
        delta = step / 2.0
        improved = True
        while improved:
            improved = False
            vec0, bw0, sc0 = best_key
            neigh: List[Key] = [(v, bw0, sc0)
                                for v in _refine_neighbours(vec0, delta)]
            neigh += [(vec0, b, sc0) for b in _grid_neighbours(bw0, bw_grid)]
            neigh += [(vec0, bw0, s)
                      for s in _grid_neighbours(sc0, scratch_grid)]
            for key, p in zip(neigh, eval_all(neigh)):
                if p is not None and obj(p) < obj(best):
                    best, best_key, improved = p, key, True
                    _MET_IMPROVED.inc()
                    if _trace_mod.ENABLED:
                        _trace_mod.TRACE.instant(
                            "incumbent_improved", pid=_trace_mod.PID_HOST,
                            tid="dse", cat="dse", stage="refine",
                            objective=objective, score=obj(p))
            if verbose and improved:
                print(f"DSE refined: {dict(best.fractions)} "
                      f"bw={best.hbm_bw:.3g} "
                      f"scratch={best.scratchpad_bytes:.3g} "
                      f"-> {objective}={obj(best):.3e}")

    fractions = best.fractions_dict
    config = cm.aespa_from_fractions(fractions, name="aespa_dse",
                                     hbm_bw=best.hbm_bw,
                                     scratchpad_bytes=best.scratchpad_bytes)
    evaluated = [p for p in seen.values() if p is not None]
    baselines = (compare_to_baselines(best.eval, suite, best.hbm_bw,
                                      fracs=fracs, refine=refine)
                 if with_baselines else {})
    return DseResult(
        config=config,
        fractions=fractions,
        geomean_runtime_s=best.eval.geomean_runtime_s,
        geomean_edp=best.eval.geomean_edp,
        geomean_energy_pj=best.eval.geomean_energy_pj,
        objective=objective,
        evaluations=len(evaluated),
        wall_time_s=time.perf_counter() - t0,
        baselines=baselines,
        pareto=pareto_front(evaluated) if with_pareto else (),
    )


# ------------------------------------------------- design × policy co-DSE
@dataclasses.dataclass(frozen=True)
class TrafficEval:
    """One (design, policy) cell of the co-DSE grid."""

    policy: str
    makespan_s: float                  # offline: whole queue, arrivals 0
    utilization: float                 # offline PE-weighted busy fraction
    online_makespan_s: float           # staggered-arrival scenario
    online_mean_wait_cycles: float
    online_mean_turnaround_cycles: float

    def objective(self, name: str) -> float:
        if name == "makespan":
            return self.makespan_s
        if name == "mean_wait":
            return self.online_mean_wait_cycles
        if name == "turnaround":
            return self.online_mean_turnaround_cycles
        raise ValueError(
            f"unknown traffic objective {name!r}; one of "
            "('makespan', 'mean_wait', 'turnaround')")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CoDseResult:
    """Best (design, policy) pair for a traffic, plus the full grid row
    of the winning design (one TrafficEval per policy)."""

    config: cm.AcceleratorConfig
    fractions: Dict[DataflowClass, float]
    policy: str
    objective: str
    best: TrafficEval
    per_policy: Dict[str, TrafficEval]
    evaluations: int
    wall_time_s: float

    def to_json(self) -> Dict:
        return {
            "config": cm.config_to_json(self.config),
            "fractions": {c.value: f for c, f in self.fractions.items()},
            "policy": self.policy,
            "objective": self.objective,
            "best": self.best.to_json(),
            "per_policy": {k: v.to_json()
                           for k, v in self.per_policy.items()},
            "evaluations": self.evaluations,
            "wall_time_s": self.wall_time_s,
        }


def traffic_arrivals(config: cm.AcceleratorConfig,
                     tasks: Sequence[Workload],
                     arrival_gap_factor: float = 0.25) -> List[float]:
    """Arrival times of the online scenario for a doubled queue: staggered
    at ``arrival_gap_factor`` × the mean per-task share of the design's
    own LPT makespan — arrivals outpace service, so queues build and the
    priority rules separate (same construction as Fig 12's online sweep).
    Depends only on ``(config, tasks)`` — compute once per design and
    share across policies."""
    base = _sched.schedule_many_kernels(config, tasks, policy="lpt")
    n = max(len(tasks) * 2, 1)
    gap = base.makespan_cycles / n * arrival_gap_factor
    return [i * gap for i in range(len(tasks) * 2)]


def evaluate_traffic(config: cm.AcceleratorConfig,
                     tasks: Sequence[Workload],
                     policy: str,
                     arrival_gap_factor: float = 0.25,
                     arrivals: Optional[Sequence[float]] = None
                     ) -> TrafficEval:
    """Offline + online many-kernel metrics of one design under one
    policy (online scenario per :func:`traffic_arrivals`; pass
    ``arrivals`` to reuse them across the policies of one design)."""
    offline = _sched.schedule_many_kernels(config, tasks, policy=policy)
    online_tasks = list(tasks) * 2
    if arrivals is None:
        arrivals = traffic_arrivals(config, tasks, arrival_gap_factor)
    online = _sched.schedule_many_kernels(config, online_tasks,
                                          policy=policy, arrivals=arrivals)
    return TrafficEval(
        policy=policy,
        makespan_s=offline.makespan_s,
        utilization=offline.stats.utilization,
        online_makespan_s=online.makespan_s,
        online_mean_wait_cycles=online.stats.mean_wait_cycles,
        online_mean_turnaround_cycles=online.stats.mean_turnaround_cycles,
    )


def co_search(
    tasks: Sequence[Workload] = TABLE_I,
    hbm_bw: Optional[float] = None,
    step: float = 0.25,
    classes: Tuple[DataflowClass, ...] = CLASSES,
    policies: Optional[Sequence[str]] = None,
    objective: str = "makespan",
    arrival_gap_factor: float = 0.25,
    max_workers: Optional[int] = None,
    verbose: bool = False,
    hbm_bw_grid: Optional[Sequence[float]] = None,
    scratchpad_grid: Optional[Sequence[float]] = None,
) -> CoDseResult:
    """Design × policy co-DSE (paper §V-B meets §VII): sweep the joint
    design space (fraction simplex × ``hbm_bw_grid`` × ``scratchpad_grid``)
    and score every candidate under every registered scheduling policy,
    offline and under an online staggered-arrival scenario, so the engine
    answers "best design *and policy* for this traffic" rather than for
    one kernel at a time.

    Many-kernel traffic evaluation is event-driven per candidate rather
    than an array sweep, but every per-(cluster, workload) placement cost
    inside it is memoized (``scheduler._best_on_cluster``), so the joint
    sweep amortizes across candidates that share memory provisioning.
    ``max_workers`` is deprecated and ignored.

    ``objective``: ``makespan`` (offline throughput), ``mean_wait`` or
    ``turnaround`` (online latency). Raises :class:`ValueError` on an
    unknown policy, a step that does not divide 1, an empty or
    non-positive memory grid, or an empty sweep.
    """
    _simplex_steps(step)
    if max_workers is not None:
        _deprecate_max_workers()
    hbm_bw = hwdb.HBM_BW if hbm_bw is None else hbm_bw
    bw_grid, scratch_grid = _memory_grids(hbm_bw, hbm_bw_grid,
                                          scratchpad_grid)
    pols = tuple(policies if policies is not None
                 else _sched.available_policies())
    for p in pols:
        _sched.get_policy(p)  # raise early on unknown names
    if not pols:
        raise ValueError("co_search needs at least one scheduling policy")
    t0 = time.perf_counter()

    if not classes:
        raise ValueError("co_search over an empty class tuple")
    candidates = []
    for vec in _simplex(step, len(classes)):
        for bw in bw_grid:
            for sc in scratch_grid:
                built = _config_for(vec, classes, bw, scratchpad_bytes=sc)
                if built is not None:
                    candidates.append(built)
    if not candidates:
        raise ValueError(
            f"co-DSE simplex over {[c.value for c in classes]} at step "
            f"{step} produced no feasible config")

    def eval_design(built) -> Tuple[Dict, cm.AcceleratorConfig,
                                    Dict[str, TrafficEval]]:
        fractions, config = built
        arrivals = traffic_arrivals(config, tasks, arrival_gap_factor)
        row = {p: evaluate_traffic(config, tasks, p, arrival_gap_factor,
                                   arrivals=arrivals)
               for p in pols}
        return fractions, config, row

    rows = [eval_design(b) for b in candidates]

    best_row = None
    for fractions, config, row in rows:
        pol = min(row, key=lambda p: row[p].objective(objective))
        cell = row[pol]
        if best_row is None or (cell.objective(objective)
                                < best_row[3].objective(objective)):
            best_row = (fractions, config, pol, cell, row)
            if verbose:
                print(f"co-DSE best so far: {fractions} × {pol} -> "
                      f"{objective}={cell.objective(objective):.3e}")
    fractions, config, pol, cell, row = best_row
    return CoDseResult(
        config=config,
        fractions=fractions,
        policy=pol,
        objective=objective,
        best=cell,
        per_policy=row,
        evaluations=len(rows) * len(pols),
        wall_time_s=time.perf_counter() - t0,
    )


# ------------------------------------------------ canonical AESPA configs
def aespa_half_tpu_outerspace(hbm_bw: float = None) -> cm.AcceleratorConfig:
    """Paper Fig 10's 'AESPA (Half TPU/OuterSPACE)' fixed-ratio config."""
    return cm.aespa_from_fractions(
        {DataflowClass.GEMM: 0.5, DataflowClass.SPGEMM_OUTER: 0.5},
        name="aespa_half_tpu_outerspace",
        hbm_bw=hwdb.HBM_BW if hbm_bw is None else hbm_bw,
    )


def aespa_equal4(hbm_bw: float = None) -> cm.AcceleratorConfig:
    """Equal areas for TPU/EIE/ExTensor/OuterSPACE — lands within ~1% of
    Fig 1's 11008-PE AESPA row (17280/4+10176/4+4992/4+12032/4 = 11120)."""
    return cm.aespa_from_fractions(
        {
            DataflowClass.GEMM: 0.25,
            DataflowClass.SPMM: 0.25,
            DataflowClass.SPGEMM_INNER: 0.25,
            DataflowClass.SPGEMM_OUTER: 0.25,
        },
        name="aespa_equal4",
        hbm_bw=hwdb.HBM_BW if hbm_bw is None else hbm_bw,
    )


def aespa_equal5(hbm_bw: float = None) -> cm.AcceleratorConfig:
    return cm.aespa_from_fractions(
        {c: 0.2 for c in CLASSES},
        name="aespa_equal5",
        hbm_bw=hwdb.HBM_BW if hbm_bw is None else hbm_bw,
    )


def aespa_opt(hbm_bw: float = None,
              suite: Sequence[Workload] = TABLE_I) -> cm.AcceleratorConfig:
    """AESPA-opt: the paper's 'high performance configuration searched by
    our model' — the two-stage EDP search with refined scheduler
    evaluation. Deterministic (the search has no randomness), and cheap on
    repeat calls thanks to schedule memoization."""
    bw = hwdb.HBM_BW if hbm_bw is None else hbm_bw
    res = search(suite=suite, hbm_bw=bw, step=0.25, objective="edp",
                 refine=True)
    return cm.AcceleratorConfig("aespa_opt", res.config.clusters, bw)
