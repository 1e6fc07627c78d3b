"""The PyTorch port's many-kernel half against the JAX package: the
scheduling policies and their queue statistics, the event-stepped
``OnlineScheduler``, and the sequential executor (``execute_assignments``,
``execute_many_kernel_schedule``, ``hetero_many_matmul``) on the same
numpy operands, with the JAX kernels in interpret mode.

Scheduler parity runs on every config, ``aespa_opt`` among them; executor
parity on a small four-cluster config and on ``aespa_opt`` (whose queues
put tasks on its Gustavson cluster).
"""
import dataclasses
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import workloads as jwl
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import hetero_matmul as thm
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.formats.taxonomy import DataflowClass as TClass

# ``repro.core`` re-exports a function named like its executor module.
jhm = sys.modules["repro.core.hetero_matmul"]

POLICIES = ["lpt", "sjf", "affinity", "optimized"]
JD = jcm.DataflowClass


def small_aespa_json():
    """``tests/test_policies.py``'s five-cluster config, carried over as
    JSON (the way a DSE result reaches the port)."""
    return jcm.AcceleratorConfig(
        "aespa_small",
        tuple(jcm.basic_cluster(c, 64) for c in (
            JD.GEMM, JD.SPMM, JD.SPGEMM_INNER, JD.SPGEMM_OUTER,
            JD.SPGEMM_GUSTAVSON)),
        math.inf)


def small4(pkg_cm, cls_enum):
    """Four 16-PE clusters, no Gustavson: the suite's dense straggler
    splits into a GEMM/SpMM/inner M×N template over k[0:72] plus an outer
    product over k[72:96] under ``optimized``, a K-split merge."""
    return pkg_cm.AcceleratorConfig(
        "aespa_small4",
        tuple(pkg_cm.basic_cluster(c, 16) for c in (
            cls_enum.GEMM, cls_enum.SPMM, cls_enum.SPGEMM_INNER,
            cls_enum.SPGEMM_OUTER)),
        math.inf)


def config_pair(name):
    if name == "aespa_equal4":
        return jdse.aespa_equal4(), tdse.aespa_equal4()
    if name == "aespa_equal4_inf":
        return jdse.aespa_equal4(math.inf), tdse.aespa_equal4(math.inf)
    if name == "aespa_opt":
        return jdse.aespa_opt(), tdse.aespa_opt()
    if name == "json_small":
        jcfg = small_aespa_json()
        return jcfg, tcm.config_from_json(jcm.config_to_json(jcfg))
    raise KeyError(name)


def twin(jw):
    return twl.Workload(jw.name, jw.application, jw.m, jw.k, jw.n, jw.d_mk,
                        jw.d_kn)


def region_tuple(r):
    return (r.m0, r.m1, r.k0, r.k1, r.n0, r.n1)


def canon_assignment(a):
    w = a.workload
    return (a.task_index, (w.name, w.application, w.m, w.k, w.n, w.d_mk,
                           w.d_kn),
            a.cluster, a.cls.value, a.mirror, a.start_cycles, a.cycles,
            a.arrival_cycles, dataclasses.asdict(a.report),
            [(region_tuple(pp.partition.region), pp.partition.cls.value,
              pp.partition.cluster, pp.partition.mirror, pp.start_cycles,
              pp.cycles) for pp in a.placed])


def canon(ms):
    return ([canon_assignment(a) for a in ms.assignments],
            ms.makespan_cycles, ms.total_bytes, ms.energy_pj, ms.policy,
            ms.makespan_s, ms.stats.to_json())


# --------------------------------------------------------------- scheduler
@pytest.mark.parametrize("case", ["aespa_equal4", "aespa_equal4_inf",
                                  "json_small", "staggered", "aespa_opt"])
@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_many_kernels_matches_jax(policy, case):
    """Table I on each config, and twice over with staggered arrivals:
    every assignment, the makespan, bytes, energy and the queue stats are
    equal, not close."""
    jtasks = list(jwl.TABLE_I)
    arrivals = None
    if case == "staggered":
        jcfg, tcfg = config_pair("aespa_equal4")
        jtasks = jtasks * 2
        arrivals = [i * 400_000.0 for i in range(len(jtasks))]
    else:
        jcfg, tcfg = config_pair(case)
    want = jsched.schedule_many_kernels(jcfg, jtasks, policy=policy,
                                        arrivals=arrivals)
    got = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks],
                                       policy=policy, arrivals=arrivals)
    assert canon(got) == canon(want)


def test_registry_and_errors_match_jax():
    assert tsched.available_policies() == jsched.available_policies()
    with pytest.raises(KeyError, match="lpt"):
        tsched.get_policy("no_such_policy")
    with pytest.raises(ValueError, match="arrivals"):
        tsched.schedule_many_kernels(tdse.aespa_equal4(),
                                     twl.TABLE_I[:2], arrivals=[0.0])
    empty = tsched.schedule_many_kernels(tdse.aespa_equal4(), [])
    assert canon(empty) == canon(jsched.schedule_many_kernels(
        jdse.aespa_equal4(), []))


def test_queue_stats_helpers_match_jax():
    """``queue_stats`` with deadlines (the serving runtime's use), and the
    percentile and cycle-to-microsecond helpers beside it."""
    jcfg, tcfg = config_pair("aespa_equal4")
    busy = [10.0, 2500.5, 0.0, 7.25]
    waits = [0.0, 3.0, 12.5, 40.0, 7.0]
    turns = [w + 100.0 for w in waits]
    finish = [110.0, 90.0, 300.0, 141.0, 99.0]
    deadlines = [100.0, None, 400.0, 140.0, 99.0]
    kw = dict(queue_depth=3, finish_cycles=finish, deadline_cycles=deadlines)
    assert (tcm.queue_stats(tcfg, busy, waits, turns, 3000.0, **kw).to_json()
            == jcm.queue_stats(jcfg, busy, waits, turns, 3000.0,
                               **kw).to_json())
    with pytest.raises(ValueError, match="finish_cycles"):
        tcm.queue_stats(tcfg, busy, waits, turns, 3000.0,
                        deadline_cycles=deadlines)
    for q in (0.0, 37.5, 50.0, 99.0, 100.0):
        assert tcm.percentile(waits, q) == jcm.percentile(waits, q)
    assert tcm.percentile([], 50.0) == 0.0
    assert tcm.cycles_to_us(12345.0) == jcm.cycles_to_us(12345.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_online_scheduler_advance_and_fork_match_jax(policy):
    """Offers with arrivals, a bounded advance, a live snapshot, a fork
    drained on its own (committing nothing to its parent), then the full
    drain: each step agrees with the JAX engine."""
    jcfg, tcfg = config_pair("aespa_equal4_inf")
    jtasks = list(jwl.TABLE_I) * 2
    arrivals = [i * 150_000.0 for i in range(len(jtasks))]
    je = jsched.OnlineScheduler(jcfg, policy)
    te = tsched.OnlineScheduler(tcfg, policy)
    for jw, t in zip(jtasks, arrivals):
        assert te.offer(twin(jw), arrival=t) == je.offer(jw, arrival=t)
    until = arrivals[len(arrivals) // 2]
    jp, tp = je.advance(until), te.advance(until)
    assert [canon_assignment(a) for a in tp] == [canon_assignment(a)
                                                  for a in jp]
    assert (te.now, te.queue_depth, te.backlog_depth) == (
        je.now, je.queue_depth, je.backlog_depth)
    assert te.live_stats().to_json() == je.live_stats().to_json()
    jf, tf = je.fork(), te.fork()
    jf.drain()
    tf.drain()
    assert canon(tf.finish()) == canon(jf.finish())
    assert te.backlog_depth == je.backlog_depth > 0
    je.drain()
    te.drain()
    assert canon(te.finish()) == canon(je.finish())
    assert canon(te.finish()) == canon(tf.finish())


# ---------------------------------------------------------------- executor
SPECS = [
    (96, 96, 96, 1.0, 1.0),       # dense straggler
    (64, 80, 48, 0.1, 1.0),       # sparse × dense (SpMM-shaped)
    (48, 64, 64, 0.05, 0.05),     # hypersparse × hypersparse
    (32, 32, 96, 0.5, 0.3),       # moderately sparse
]
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def suite(seed):
    """``tests/test_policies.py``'s four-task suite as numpy operands."""
    rng = np.random.default_rng(seed)
    pairs, jtasks = [], []
    for i, (m, k, n, dmk, dkn) in enumerate(SPECS):
        a = rng.standard_normal((m, k)) * (rng.random((m, k)) < dmk)
        b = rng.standard_normal((k, n)) * (rng.random((k, n)) < dkn)
        pairs.append((a.astype(np.float32), b.astype(np.float32)))
        jtasks.append(jwl.Workload(f"t{i}", "parity", m, k, n, dmk, dkn))
    return pairs, jtasks


def jax_pairs(pairs, dtype):
    dt = JAX_DTYPE[dtype]
    return [(jnp.asarray(a, dt), jnp.asarray(b, dt)) for a, b in pairs]


def torch_pairs(pairs, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
            for a, b in pairs]


def tol(dtype, want):
    if dtype == "bfloat16":
        # K-split partials round to bf16 before merging: a few bf16 ULPs of
        # the largest partial (tests/test_policies.py's bound).
        return dict(rtol=3e-2,
                    atol=2e-2 + 4 * 2.0 ** -8 * float(np.abs(want).max()))
    return dict(rtol=1e-4, atol=1e-4)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_execute_many_kernel_schedule_matches_jax(policy, dtype):
    pairs, jtasks = suite(7)
    jcfg, tcfg = small4(jcm, JD), small4(tcm, TClass)
    jms = jsched.schedule_many_kernels(jcfg, jtasks, policy=policy)
    tms = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks],
                                       policy=policy)
    assert canon(tms) == canon(jms)
    if policy == "optimized":
        split = [a for a in tms.assignments if a.split]
        assert split and len({(pp.partition.region.k0,
                               pp.partition.region.k1)
                              for pp in split[0].placed}) > 1
    want = jhm.execute_many_kernel_schedule(jax_pairs(pairs, dtype), jms,
                                            interpret=True, block=32)
    got = thm.execute_many_kernel_schedule(torch_pairs(pairs, dtype), tms,
                                           block=32, device="cpu")
    for (a, b), g, w in zip(pairs, got, want):
        dense = a @ b
        assert tuple(g.shape) == dense.shape
        np.testing.assert_allclose(as_np(g), as_np(w), **tol(dtype, dense))
        np.testing.assert_allclose(as_np(g), dense, **tol(dtype, dense))


def test_execute_assignments_by_task_index():
    """A batch of assignments (a serving runtime's admitted batch) runs by
    task index, whatever order it arrives in."""
    pairs, jtasks = suite(5)
    tms = tsched.schedule_many_kernels(small4(tcm, TClass),
                                       [twin(w) for w in jtasks])
    batch = list(reversed(tms.assignments))[:2]
    outs = thm.execute_assignments(batch, dict(enumerate(pairs)), tms.config,
                                   block=32, device="cpu")
    assert sorted(outs) == sorted(a.task_index for a in batch)
    for i, out in outs.items():
        np.testing.assert_allclose(as_np(out), pairs[i][0] @ pairs[i][1],
                                   rtol=1e-4, atol=1e-4)


def test_execute_assignments_casts_float64_like_jax():
    """float64 numpy operands (``np.random`` gives them) come out float32
    and equal JAX's, which makes them float32 in ``jnp.asarray``."""
    pairs, jtasks = suite(5)
    pairs64 = {i: (a.astype(np.float64), b.astype(np.float64))
               for i, (a, b) in enumerate(pairs)}
    jcfg, tcfg = small4(jcm, JD), small4(tcm, TClass)
    jms = jsched.schedule_many_kernels(jcfg, jtasks)
    tms = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks])
    assert canon(tms) == canon(jms)
    want = jhm.execute_assignments(jms.assignments, pairs64, jcfg,
                                   interpret=True, block=32)
    got = thm.execute_assignments(tms.assignments, pairs64, tcfg, block=32,
                                  device="cpu")
    assert sorted(got) == sorted(want)
    for i, out in got.items():
        assert out.dtype == torch.float32
        assert np.asarray(want[i]).dtype == np.float32
        np.testing.assert_allclose(as_np(out), as_np(want[i]), rtol=1e-4,
                                   atol=1e-4)


def test_hetero_many_matmul_casts_float64_like_jax():
    pairs, _ = suite(11)
    pairs64 = [(a.astype(np.float64), b.astype(np.float64))
               for a, b in pairs]
    want, jms = jhm.hetero_many_matmul(pairs64, small4(jcm, JD),
                                       interpret=True, block=32)
    got, tms = thm.hetero_many_matmul(pairs64, small4(tcm, TClass),
                                      block=32, device="cpu")
    assert [a.cls.value for a in tms.assignments] == [
        a.cls.value for a in jms.assignments]
    for (a, b), g, w in zip(pairs64, got, want):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(as_np(g), a @ b, rtol=1e-4, atol=1e-4)


def test_executor_rejects_mismatched_operands():
    pairs, jtasks = suite(0)
    tms = tsched.schedule_many_kernels(small4(tcm, TClass),
                                       [twin(w) for w in jtasks])
    with pytest.raises(ValueError, match="operand pairs"):
        thm.execute_many_kernel_schedule(pairs[:-1], tms, device="cpu")
    bad = list(pairs)
    bad[0] = (bad[0][0][:-1], bad[0][1])
    with pytest.raises(ValueError, match="match scheduled dims"):
        thm.execute_many_kernel_schedule(bad, tms, device="cpu")


def test_hetero_many_matmul_matches_jax():
    """Densities measured from the operands, scheduled, executed. The port
    measures exact densities where JAX takes float32 means, so the
    schedules agree in placements, the reports to rounding."""
    pairs, _ = suite(11)
    want, jms = jhm.hetero_many_matmul(
        jax_pairs(pairs, "float32"), small4(jcm, JD), policy="optimized",
        interpret=True, block=32)
    got, tms = thm.hetero_many_matmul(pairs, small4(tcm, TClass),
                                      policy="optimized", block=32,
                                      device="cpu")
    assert tms.policy == "optimized"
    placements = [[(region_tuple(pp.partition.region), pp.partition.cls.value,
                    pp.partition.cluster, pp.partition.mirror)
                   for pp in a.placed] for a in tms.assignments]
    assert placements == [[(region_tuple(pp.partition.region),
                            pp.partition.cls.value, pp.partition.cluster,
                            pp.partition.mirror) for pp in a.placed]
                          for a in jms.assignments]
    # Cycle counts round up, so a last-bit density difference can move the
    # makespan by a cycle.
    assert abs(tms.makespan_cycles - jms.makespan_cycles) <= 1.0
    for (a, b), g, w in zip(pairs, got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(as_np(g), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("policy", POLICIES)
def test_aespa_opt_queue_matches_jax(policy):
    """The Table I queue, scaled down, on the searched design: placements
    equal to the JAX package's, and every task's output equal to the JAX
    executor's and to ``a @ b``. Under ``lpt`` and ``optimized`` gnmt runs
    whole on the Gustavson cluster."""
    jcfg, tcfg = config_pair("aespa_opt")
    pairs, jtasks = [], []
    for jw in jwl.TABLE_I:
        a, b, dims = jwl.synthesize(jw, seed=1, max_elems=1 << 14)
        pairs.append((a, b))
        jtasks.append(jwl.Workload(jw.name, jw.application, *dims, jw.d_mk,
                                   jw.d_kn))
    jms = jsched.schedule_many_kernels(jcfg, jtasks, policy=policy)
    tms = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks],
                                       policy=policy)
    assert canon(tms) == canon(jms)
    gust = {a.workload.name for a in tms.assignments
            if a.cls == TClass.SPGEMM_GUSTAVSON}
    if policy in ("lpt", "optimized"):
        assert "gnmt" in gust
    want = jhm.execute_many_kernel_schedule(jax_pairs(pairs, "float32"),
                                            jms, interpret=True, block=64)
    got = thm.execute_many_kernel_schedule(torch_pairs(pairs, "float32"),
                                           tms, block=64, device="cpu")
    for (a, b), g, w in zip(pairs, got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(as_np(g), a @ b, rtol=1e-4, atol=1e-4)
