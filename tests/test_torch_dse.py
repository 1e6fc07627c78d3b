"""The PyTorch port's design-space exploration (``repro_torch.core.dse``,
the batched evaluator of ``costmodel`` and ``scheduler``) against the JAX
package's: the same candidate batches and suites give the same floats, not
close ones, and the same searched designs, ``aespa_opt`` among them.

The oracle is always the JAX package's batched evaluator (or its search),
never its scalar path: ``tests/test_dse.py::
test_batched_evaluator_bit_equal_to_scalar`` compares those two and fails
on a recorded example, which the batches below include.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import hwdb as jhwdb
from repro.core import scheduler as jsched
from repro.core import workloads as jwl
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import hwdb as thwdb
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.formats.taxonomy import DataflowClass as TClass

SMALL_SUITE = [("dense", "t", 128, 128, 128, 1.0, 1.0),
               ("sparse", "t", 128, 128, 128, 0.01, 0.01)]


def suites(name):
    """``(jax suite, port suite)``: Table I, or ``tests/test_dse.py``'s
    two-workload suite."""
    if name == "table_i":
        return list(jwl.TABLE_I), list(twl.TABLE_I)
    return ([jwl.Workload(*w) for w in SMALL_SUITE],
            [twl.Workload(*w) for w in SMALL_SUITE])


def lattice():
    """Candidate batch rows ``(g, s, i, o, u, bw_factor, scratch_factor)``:
    the recorded Hypothesis example first, then lattice points over the
    five classes with every memory factor the property test draws, one
    infeasible (all zero) and single-class candidates."""
    rows = [(4, 4, 2, 1, 4, 0.25, 1 / 16)]
    rng = np.random.default_rng(0)
    bws = [0.25, 1.0, 4.0, math.inf]
    scratches = [1 / 16, 1.0, 4.0]
    for _ in range(24):
        g, s, i, o, u = (int(x) for x in rng.integers(0, 5, size=5))
        rows.append((g, s, i, o, u, bws[rng.integers(4)],
                     scratches[rng.integers(3)]))
    rows += [(0, 0, 0, 0, 0, 1.0, 1.0), (1, 0, 0, 0, 0, 1.0, 1.0),
             (0, 0, 0, 0, 3, math.inf, 4.0)]
    return rows


def batch_args(rows):
    vecs, bws, scratch = [], [], []
    for *counts, bw_factor, scratch_factor in rows:
        total = sum(counts)
        vecs.append([c / total if total else 0.0 for c in counts])
        bws.append(jhwdb.HBM_BW * bw_factor)
        scratch.append(jhwdb.SCRATCH_BYTES * scratch_factor)
    return np.asarray(vecs), np.asarray(bws), np.asarray(scratch)


def batches(rows=None):
    vecs, bws, scratch = batch_args(lattice() if rows is None else rows)
    jb = jcm.ConfigBatch.from_fractions(vecs, jdse.CLASSES, hbm_bw=bws,
                                        scratchpad_bytes=scratch)
    tb = tcm.ConfigBatch.from_fractions(vecs, tdse.CLASSES, hbm_bw=bws,
                                        scratchpad_bytes=scratch)
    return jb, tb


@pytest.fixture(params=[False, True], ids=["compulsory", "reuse_aware"])
def traffic(request):
    """Both packages under the same traffic model, restored afterwards."""
    jprev = jcm.set_reuse_aware_traffic(request.param)
    tprev = tcm.set_reuse_aware_traffic(request.param)
    yield request.param
    jcm.set_reuse_aware_traffic(jprev)
    tcm.set_reuse_aware_traffic(tprev)


def test_hwdb_and_classes_match_jax():
    assert [c.value for c in tdse.CLASSES] == [c.value for c in jdse.CLASSES]
    assert (thwdb.HBM_BW, thwdb.SCRATCH_BYTES, thwdb.COMPUTE_MM2) == (
        jhwdb.HBM_BW, jhwdb.SCRATCH_BYTES, jhwdb.COMPUTE_MM2)
    assert tdse.SCHED_FRACS == jdse.SCHED_FRACS


def test_config_batch_from_fractions_matches_jax():
    jb, tb = batches()
    assert [c.value for c in tb.classes] == [c.value for c in jb.classes]
    np.testing.assert_array_equal(tb.pes, jb.pes)
    np.testing.assert_array_equal(tb.hbm_bw, jb.hbm_bw)
    np.testing.assert_array_equal(tb.scratchpad_bytes, jb.scratchpad_bytes)
    np.testing.assert_array_equal(tb.feasible, jb.feasible)
    assert tb.n == jb.n and not tb.feasible.all()
    for i in np.flatnonzero(tb.feasible):
        assert (tcm.config_to_json(tb.config(int(i)))
                == jcm.config_to_json(jb.config(int(i))))
    with pytest.raises(ValueError, match="does not match"):
        tcm.ConfigBatch.from_fractions(np.ones((2, 3)), tdse.CLASSES)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("suite", ["table_i", "small"])
def test_batch_single_kernel_eval_matches_jax(suite, refine, traffic):
    jb, tb = batches()
    for jw, tw in zip(*suites(suite)):
        jrt, jen = jsched.batch_single_kernel_eval(jb, jw, refine=refine)
        trt, ten = tsched.batch_single_kernel_eval(tb, tw, refine=refine)
        np.testing.assert_array_equal(trt, jrt)
        np.testing.assert_array_equal(ten, jen)


def test_batch_template_eval_joint_matches_jax(traffic):
    jb, tb = batches()
    fm = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 0.125])
    fk = np.array([1.0, 0.75, 0.5, 0.25, 0.0, 0.875])
    fn = np.array([0.5, 0.5, 0.0, 1.0, 0.25, 0.625])
    for jw, tw in zip(*suites("table_i")):
        want = jsched.batch_template_eval_joint(jb, jw, fm, fk, fn)
        got = tsched.batch_template_eval_joint(tb, tw, fm, fk, fn)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("refine", [False, True])
def test_evaluate_config_batch_matches_jax(refine, traffic):
    jb, tb = batches()
    jsuite, tsuite = suites("table_i")
    want = jcm.evaluate_config_batch(jb, jsuite, refine=refine)
    got = tcm.evaluate_config_batch(tb, tsuite, refine=refine)
    for name in ("edp", "runtime", "energy"):
        np.testing.assert_array_equal(got.objective(name),
                                      want.objective(name))
    assert got.n == jb.n
    assert np.isinf(got.geomean_edp[~tb.feasible]).all()
    with pytest.raises(ValueError, match="unknown objective"):
        got.objective("speed")


@pytest.mark.parametrize("name", ["aespa_equal4", "aespa_equal5",
                                  "aespa_half_tpu_outerspace"])
def test_evaluate_suite_and_baselines_match_jax(name):
    """The scalar evaluation of the canonical designs and their ratios to
    the homogeneous baselines, on the small suite."""
    jcfg, tcfg = getattr(jdse, name)(), getattr(tdse, name)()
    assert tcm.config_to_json(tcfg) == jcm.config_to_json(jcfg)
    jsuite, tsuite = suites("small")
    jev = jdse.evaluate_suite(jcfg, jsuite, refine=True)
    tev = tdse.evaluate_suite(tcfg, tsuite, refine=True)
    assert dataclasses.asdict(tev) == dataclasses.asdict(jev)
    assert (tdse.evaluate_config(tcfg, tsuite)
            == jdse.evaluate_config(jcfg, jsuite))
    jr = jdse.compare_to_baselines(jev, jsuite, refine=True)
    tr = tdse.compare_to_baselines(tev, tsuite, refine=True)
    assert {k: v.to_json() for k, v in tr.items()} == {
        k: v.to_json() for k, v in jr.items()}


def result_json(res):
    d = res.to_json()
    del d["wall_time_s"]
    return d


@pytest.mark.parametrize("kw", [
    dict(step=0.25),
    dict(step=0.5, with_baselines=True, with_pareto=True),
    dict(step=0.5, objective="runtime", refine=True),
    dict(step=0.5, objective="energy", refine_fractions=False),
    dict(step=0.5, with_pareto=True,
         hbm_bw_grid=[jhwdb.HBM_BW / 4, jhwdb.HBM_BW, 4 * jhwdb.HBM_BW],
         scratchpad_grid=[jhwdb.SCRATCH_BYTES / 16, jhwdb.SCRATCH_BYTES]),
    dict(step=0.5, classes=("gemm", "spgemm_gustavson"),
         hbm_bw=math.inf),
], ids=["step_quarter", "baselines_pareto", "runtime_refined", "energy",
        "memory_grids", "two_classes_inf_bw"])
def test_search_matches_jax(kw):
    kw = dict(kw)
    classes = kw.pop("classes", None)
    jkw, tkw = dict(kw), dict(kw)
    if classes is not None:
        jkw["classes"] = tuple(jcm.DataflowClass(c) for c in classes)
        tkw["classes"] = tuple(TClass(c) for c in classes)
    jsuite, tsuite = suites("small")
    want = jdse.search(suite=jsuite, **jkw)
    got = tdse.search(suite=tsuite, **tkw)
    assert result_json(got) == result_json(want)
    assert got.evaluations == want.evaluations > 0
    if kw.get("with_pareto"):
        assert got.pareto and [p.to_json() for p in tdse.pareto_front(
            got.pareto)] == [p.to_json() for p in got.pareto]


def test_aespa_opt_matches_jax():
    """The paper's searched design on full Table I: the same clusters, PE
    counts and memory system as the JAX package's, four clusters with a
    Gustavson one and no outer product."""
    want = jcm.config_to_json(jdse.aespa_opt())
    got = tcm.config_to_json(tdse.aespa_opt())
    assert got == want
    assert [c["name"] for c in got["clusters"]] == [
        "gemm", "spmm", "spgemm_inner", "spgemm_gustavson"]
    assert (tcm.config_to_json(tdse.aespa_opt(hbm_bw=2e12))
            == jcm.config_to_json(jdse.aespa_opt(hbm_bw=2e12)))


@pytest.mark.parametrize("bad,match", [
    (dict(step=0.3), "does not divide 1"),
    (dict(step=1.5), "step must be in"),
    (dict(objective="speed_of_light"), "objective"),
    (dict(classes=()), "empty class tuple"),
    (dict(hbm_bw_grid=[]), "non-empty"),
    (dict(scratchpad_grid=[0.0]), "positive"),
])
def test_search_rejects_what_jax_rejects(bad, match):
    jsuite, tsuite = suites("small")
    with pytest.raises(ValueError, match=match):
        jdse.search(suite=jsuite, **bad)
    with pytest.raises(ValueError, match=match):
        tdse.search(suite=tsuite, **bad)


def test_schedule_cache_info_counts_memo_hits():
    tsched.clear_schedule_cache()
    tw = twl.TABLE_I[0]
    info0 = tsched.schedule_cache_info()
    assert set(info0) == {"single_kernel_memo", "best_on_cluster"}
    assert info0["single_kernel_memo"]["currsize"] == 0
    cfg = tdse.aespa_equal4()
    first = tsched.schedule_single_kernel(cfg, tw, memo=True)
    again = tsched.schedule_single_kernel(cfg, tw, memo=True)
    assert again is first
    info = tsched.schedule_cache_info()["single_kernel_memo"]
    assert (info["hits"], info["misses"], info["currsize"]) == (1, 1, 1)
    assert info["maxsize"] == jsched.schedule_cache_info()[
        "single_kernel_memo"]["maxsize"]


@pytest.mark.parametrize("name", ["search", "co_search"])
def test_search_signatures_match_jax(name):
    """Same parameter names in the same order as JAX's, so a call written
    for ``repro`` binds the same parameters in the port, by keyword or by
    position."""
    import inspect

    jparams = list(inspect.signature(getattr(jdse, name)).parameters)
    tparams = list(inspect.signature(getattr(tdse, name)).parameters)
    assert tparams == jparams


def test_search_and_co_search_warn_on_max_workers():
    """The port's twin of ``tests/test_dse.py``'s
    ``test_search_and_co_search_warn_on_max_workers``."""
    jsuite, tsuite = suites("small")
    with pytest.warns(DeprecationWarning, match="max_workers"):
        tdse.search(suite=tsuite, step=0.5, max_workers=4)
    with pytest.warns(DeprecationWarning, match="max_workers"):
        tdse.co_search(tasks=tsuite, step=0.5,
                       classes=(TClass.GEMM, TClass.SPGEMM_INNER),
                       policies=("lpt",), max_workers=2)
    assert not hasattr(tdse, "_default_workers")
    assert not hasattr(tdse, "ThreadPoolExecutor")


def test_verbose_prints_match_jax(capsys):
    """``verbose=True`` prints the same progress lines in both packages:
    the coarse incumbent and each refinement of ``search``, and each new
    best of ``co_search``."""
    from repro.formats.taxonomy import DataflowClass as JClass

    jsuite, tsuite = suites("small")
    jdse.search(suite=jsuite, step=0.5, refine_fractions=True,
                verbose=True)
    jdse.co_search(tasks=jsuite, step=0.5,
                   classes=(JClass.GEMM, JClass.SPGEMM_INNER),
                   policies=("lpt", "sjf"), verbose=True)
    want = capsys.readouterr().out
    tdse.search(suite=tsuite, step=0.5, refine_fractions=True, verbose=True)
    tdse.co_search(tasks=tsuite, step=0.5,
                   classes=(TClass.GEMM, TClass.SPGEMM_INNER),
                   policies=("lpt", "sjf"), verbose=True)
    got = capsys.readouterr().out
    assert "DSE coarse best" in want and "co-DSE best so far" in want
    assert got == want
