"""The port's serving runtime (``repro_torch.serve.cluster``) and co-DSE
(``repro_torch.core.dse.co_search``) against the JAX package's.

``tests/test_serving.py``'s scenarios go through both packages with
``execute=False`` (scheduling and telemetry only, no card): the replayable
JSON of the two serve runs must be equal, not close. A few run with
``execute=True`` on the CPU, the port's outputs within
``tests/test_kernels.py``'s tolerances of JAX's (interpret mode), and the
streamed serve (``mesh=StreamMesh(8, device="cpu")``) the same bits as the
sequential one, with its measured timelines in the JSON.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.serve import cluster as jsc
from repro_torch import obs as tobs
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.core.stream_exec import StreamMesh
from repro_torch.serve import cluster as tsc

JD, TD = jcm.DataflowClass, tcm.DataflowClass
POLICIES = ["lpt", "sjf", "affinity", "optimized"]


def small_aespa(pkg_cm, cls_enum, hbm_bw=math.inf):
    return pkg_cm.AcceleratorConfig(
        "aespa_small",
        tuple(pkg_cm.basic_cluster(c, 64) for c in (
            cls_enum.GEMM, cls_enum.SPMM, cls_enum.SPGEMM_INNER,
            cls_enum.SPGEMM_OUTER, cls_enum.SPGEMM_GUSTAVSON)),
        hbm_bw)


def configs():
    return small_aespa(jcm, JD), small_aespa(tcm, TD)


def traces(n=10, seed=1, gap=1500.0, **kw):
    """``tests/test_serving.py``'s contended trace, made by each package."""
    return (jsc.generate_trace(n, seed=seed, mean_gap_cycles=gap, **kw),
            tsc.generate_trace(n, seed=seed, mean_gap_cycles=gap, **kw))


def run_both(server_kw=None, n=10, seed=1, gap=1500.0, trace_kw=None,
             **serve_kw):
    jcfg, tcfg = configs()
    jtr, ttr = traces(n, seed, gap, **(trace_kw or {}))
    kw = server_kw or {}
    jr = jsc.ClusterServer(jcfg, **kw).run_trace(jtr, execute=False,
                                                 **serve_kw)
    tr = tsc.ClusterServer(tcfg, **kw).run_trace(ttr, execute=False,
                                                 **serve_kw)
    return jr, tr


def same_json(jr, tr):
    j, t = jsc.serve_result_to_json(jr), tsc.serve_result_to_json(tr)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)


# ------------------------------------------------------------ trace schema
def test_trace_json_crosses_packages(tmp_path):
    jtr, ttr = traces(6, deadline_slack_cycles=1e5)
    assert tsc.trace_to_json(ttr) == jsc.trace_to_json(jtr)
    tsc.save_trace(tmp_path / "t.json", ttr)
    assert jsc.trace_to_json(jsc.load_trace(tmp_path / "t.json")) == \
        tsc.trace_to_json(ttr)
    jsc.save_trace(tmp_path / "j.json", jtr)
    assert tsc.load_trace(tmp_path / "j.json") == ttr
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    with pytest.raises(ValueError, match="version"):
        tsc.trace_from_json({"version": 99, "requests": []})


def test_request_operands_match_jax():
    jtr, ttr = traces(4, seed=3)
    for jr, tr in zip(jtr, ttr):
        for x, y in zip(jsc.request_operands(jr), tsc.request_operands(tr)):
            np.testing.assert_array_equal(np.asarray(x), y)
    big = tsc.Request("r0", "t", twl.Workload("big", "x", 9000, 9000, 9000,
                                              0.1, 0.1), 0.0)
    with pytest.raises(ValueError, match="downscaled"):
        tsc.request_operands(big)


# ----------------------------------------- server ≡ JAX server ≡ offline
@pytest.mark.parametrize("policy", POLICIES)
def test_server_report_json_matches_jax(policy):
    jr, tr = run_both(dict(policy=policy))
    same_json(jr, tr)
    off = tsched.schedule_many_kernels(
        tr.schedule.config, [r.request.workload for r in tr.results],
        policy=policy, arrivals=[r.request.arrival_cycles
                                 for r in tr.results])
    assert tr.schedule.makespan_cycles == off.makespan_cycles
    assert tr.report.stats.p99_wait_cycles == off.stats.p99_wait_cycles
    assert tr.report.stats.busy_fraction == off.stats.busy_fraction


@pytest.mark.parametrize("window,depth", [(3000.0, 3), (5000.0, None),
                                          (0.0, 2)])
def test_server_window_and_depth_gate_match_jax(window, depth):
    jr, tr = run_both(dict(policy="sjf", batch_window_cycles=window,
                           max_queue_depth=depth), n=12)
    same_json(jr, tr)
    assert [r.admitted_cycles for r in tr.results] == \
        [r.admitted_cycles for r in jr.results]
    if window:
        assert tr.report.n_batches < len(tr.results)


def test_backpressure_between_windows_matches_jax():
    """The depth cap exceeded only between admission windows: both
    servers defer the second window past its close, and both bump their
    own ``serve.backpressure_deferrals`` counter by the same amount."""
    jcfg, tcfg = configs()
    reports, bumps = [], []
    for sc, cfg, obs_mod, wl in (
            (jsc, jcfg, jobs, jsc.generate_trace(1, seed=1,
                                                 mean_gap_cycles=1500.0)),
            (tsc, tcfg, tobs, tsc.generate_trace(1, seed=1,
                                                 mean_gap_cycles=1500.0))):
        w = wl[0].workload
        trace = [sc.Request(f"burst{i}", "t", w, arrival_cycles=float(i))
                 for i in range(6)]
        trace.append(sc.Request("late", "t", w, arrival_cycles=600.0))
        key = "serve.backpressure_deferrals"
        before = obs_mod.METRICS.snapshot()["counters"].get(key, 0)
        sr = sc.ClusterServer(cfg, policy="lpt", batch_window_cycles=500.0,
                              max_queue_depth=2).run_trace(trace,
                                                           execute=False)
        bumps.append(obs_mod.METRICS.snapshot()["counters"][key] - before)
        reports.append(sr)
    same_json(*reports)
    assert bumps[0] == bumps[1] > 0
    late = next(r for r in reports[1].results
                if r.request.request_id == "late")
    assert late.admitted_cycles > 1100.0


def test_deadlines_and_tenant_accounting_match_jax():
    jr, tr = run_both(dict(policy="sjf"), trace_kw=dict(
        tenants=("alice", "bob"), deadline_slack_cycles=1.0))
    same_json(jr, tr)
    rep = tr.report
    assert rep.stats.deadline_misses == rep.stats.deadline_total == 10
    assert {t.tenant for t in rep.per_tenant} == {"alice", "bob"}


def test_empty_trace_and_duplicate_ids_match_jax():
    jcfg, tcfg = configs()
    jr = jsc.ClusterServer(jcfg).serve()
    tr = tsc.ClusterServer(tcfg).serve()
    same_json(jr, tr)
    assert tr.results == () and tr.schedule.makespan_cycles == 0.0
    w = twl.Workload("w", "t", 32, 32, 32, 1.0, 1.0)
    srv = tsc.ClusterServer(tcfg)
    srv.extend([tsc.Request("same", "t", w, 0.0),
                tsc.Request("same", "t", w, 1.0)])
    with pytest.raises(ValueError, match="duplicate"):
        srv.serve(execute=False)
    with pytest.raises(ValueError, match="window"):
        tsc.ClusterServer(tcfg, batch_window_cycles=-1.0)
    with pytest.raises(ValueError, match="max_queue_depth"):
        tsc.ClusterServer(tcfg, max_queue_depth=0)


def test_serve_pipeline_knobs_validated_like_jax():
    jcfg, tcfg = configs()
    jtr, ttr = traces(2)
    for kw, match in ((dict(pipeline_depth=2), "mesh"),
                      (dict(measure=True), "mesh"),
                      (dict(pipeline_depth=0), "pipeline_depth"),
                      (dict(mesh=StreamMesh(8, device="cpu"),
                            measure=True, shard_operands=False),
                       "shard_operands")):
        jkw = dict(kw, mesh=object()) if "mesh" in kw else kw
        with pytest.raises(ValueError, match=match):
            jsc.ClusterServer(jcfg).run_trace(jtr, execute=False, **jkw)
        with pytest.raises(ValueError, match=match):
            tsc.ClusterServer(tcfg).run_trace(ttr, execute=False, **kw)


def test_serve_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve() runs on it")
    _, tcfg = configs()
    _, ttr = traces(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.ClusterServer(tcfg).run_trace(ttr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.ClusterServer(tcfg).run_trace(ttr, mesh=StreamMesh(8))
    # Telemetry alone needs no card.
    assert tsc.ClusterServer(tcfg).run_trace(ttr, execute=False).results


# ---------------------------------------------------------- numeric parity
@pytest.fixture(scope="module")
def served():
    """An executed 8-request serve under ``optimized`` in both packages
    (JAX in interpret mode), and the port's streamed serve of the same
    trace with ``pipeline_depth=2`` and ``measure=True``."""
    jcfg, tcfg = configs()
    jtr, ttr = traces(8, seed=2)
    kw = dict(policy="optimized", batch_window_cycles=4000.0)
    jr = jsc.ClusterServer(jcfg, **kw).run_trace(jtr, block=32,
                                                 interpret=True)
    tr = tsc.ClusterServer(tcfg, **kw).run_trace(ttr, block=32,
                                                 device="cpu")
    st = tsc.ClusterServer(tcfg, **kw).run_trace(
        ttr, block=32, mesh=StreamMesh(8, device="cpu"), pipeline_depth=2,
        measure=True)
    return jr, tr, st


def test_served_outputs_match_jax_and_dense(served):
    jr, tr, _ = served
    same_json(jr, tr)
    for j, t in zip(jr.results, tr.results):
        a, b = tsc.request_operands(t.request)
        got = t.output.numpy()
        np.testing.assert_allclose(got, np.asarray(j.output), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


def test_streamed_serve_bit_equal_with_measured_timelines(served):
    _, tr, st = served
    for t, s in zip(tr.results, st.results):
        assert torch.equal(t.output, s.output)
    assert st.report.n_batches > 1
    assert len(st.timelines) == st.report.n_batches
    n_clusters = len(st.schedule.config.clusters)
    assert all(len(tl.spans) == n_clusters for tl in st.timelines)
    s = st.report.stats
    assert len(s.measured_busy_s) == n_clusters
    assert s.measured_makespan_s > 0.0
    assert s.measured_sequential_s == pytest.approx(sum(s.measured_busy_s))
    assert s.measured_spatial_speedup > 0.0
    j = tsc.serve_result_to_json(st)
    assert [t["batch_id"] for t in j["timelines"]] == list(
        range(st.report.n_batches))
    assert j["report"]["stats"]["measured_spatial_speedup"] == \
        s.measured_spatial_speedup
    json.dumps(j)
    # Placements and modelled telemetry as the sequential serve's.
    unmeasured = {k: v for k, v in j["report"]["stats"].items()
                  if not k.startswith("measured_")}
    plain = tsc.serve_result_to_json(tr)
    assert unmeasured == {k: v for k, v in plain["report"]["stats"].items()
                          if not k.startswith("measured_")}
    assert j["results"] == plain["results"]
    assert "timelines" not in plain


def test_serve_trace_events_match_jax_for_equal_timelines(served, tmp_path):
    """``serve_trace_events`` and the exported Chrome trace are the same
    JSON in both packages, measured rows included, for the same
    timelines."""
    from repro.core import sharded_exec as jse
    from repro_torch.core import stream_exec as tse

    jr, tr, _ = served
    tl = lambda pkg: (pkg.BatchTimeline(  # noqa: E731
        0, 2, 0.0, 0.5, (pkg.SpanTiming(0, 0, 2, 0.01, 0.25),
                         pkg.SpanTiming(3, 5, 7, 0.02, 0.4))),)
    j2 = dataclasses.replace(jr, timelines=tl(jse))
    t2 = dataclasses.replace(tr, timelines=tl(tse))
    assert tsc.serve_trace_events(t2) == jsc.serve_trace_events(j2)
    pj = j2.export_chrome_trace(tmp_path / "j.json")
    pt = t2.export_chrome_trace(tmp_path / "t.json")
    assert pj.read_text() == pt.read_text()


def test_serve_accepts_explicit_operands_and_bf16():
    _, tcfg = configs()
    w = twl.Workload("explicit", "test", 48, 48, 32, 1.0, 0.3)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((48, 48)).astype(np.float32)
    b = (rng.standard_normal((48, 32))
         * (rng.random((48, 32)) < 0.3)).astype(np.float32)
    req = tsc.Request("rx", "t", w, 0.0)
    for ab, tol_ in (((a, b), 1e-4),
                     ((torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(b).bfloat16()), 2e-2)):
        seq = tsc.ClusterServer(tcfg).run_trace([req], operands={"rx": ab},
                                                block=32, device="cpu")
        st = tsc.ClusterServer(tcfg).run_trace(
            [req], operands={"rx": ab}, block=32,
            mesh=StreamMesh(8, device="cpu"))
        out = seq.results[0].output
        assert torch.equal(out, st.results[0].output)
        np.testing.assert_allclose(out.float().numpy(), a @ b, rtol=tol_,
                                   atol=tol_ * float(np.abs(a @ b).max()))


# ------------------------------------------------------------- DSE bridge
def example_tasks(pkg_sc):
    """``examples/serve_cluster.py``'s co-DSE task set: the distinct
    workloads of its trace (``generate_trace``'s default templates)."""
    reqs = pkg_sc.generate_trace(24, seed=11, mean_gap_cycles=1.0)
    return sorted({r.workload for r in reqs}, key=lambda w: w.name)


def co_json(res):
    d = res.to_json()
    d.pop("wall_time_s")
    return d


@pytest.mark.parametrize("objective", ["makespan", "mean_wait",
                                       "turnaround"])
def test_co_search_and_deploy_from_dse_match_jax(objective):
    jres = jdse.co_search(tasks=example_tasks(jsc), hbm_bw=math.inf,
                          step=0.5, objective=objective)
    tres = tdse.co_search(tasks=example_tasks(tsc), hbm_bw=math.inf,
                          step=0.5, objective=objective)
    assert co_json(tres) == co_json(jres)
    jsrv = jsc.deploy_from_dse(jres, batch_window_cycles=100.0)
    tsrv = tsc.deploy_from_dse(tres, batch_window_cycles=100.0)
    assert tsrv.policy.name == jsrv.policy.name == tres.policy
    assert tcm.config_to_json(tsrv.config) == jcm.config_to_json(jsrv.config)
    jtr, ttr = traces(5)
    same_json(jsrv.run_trace(jtr, execute=False),
              tsrv.run_trace(ttr, execute=False))


def test_traffic_helpers_and_co_search_errors_match_jax():
    jtasks, ttasks = example_tasks(jsc), example_tasks(tsc)
    jcfg, tcfg = configs()
    assert tdse.traffic_arrivals(tcfg, ttasks) == \
        jdse.traffic_arrivals(jcfg, jtasks)
    for pol in POLICIES:
        assert tdse.evaluate_traffic(tcfg, ttasks, pol).to_json() == \
            jdse.evaluate_traffic(jcfg, jtasks, pol).to_json()
    with pytest.raises(ValueError, match="traffic objective"):
        tdse.evaluate_traffic(tcfg, ttasks, "lpt").objective("nope")
    with pytest.raises(KeyError):
        tdse.co_search(tasks=ttasks, policies=["nope"], step=0.5)
    with pytest.raises(ValueError, match="at least one"):
        tdse.co_search(tasks=ttasks, policies=[], step=0.5)
    with pytest.raises(ValueError, match="empty class"):
        tdse.co_search(tasks=ttasks, classes=(), step=0.5)
    srv = tsc.deploy_from_dse(tcfg, hbm_bw=1e12, policy="sjf")
    assert srv.config.hbm_bw == 1e12 and srv.policy.name == "sjf"
    res = tdse.search(suite=ttasks, hbm_bw=math.inf, step=0.5,
                      with_baselines=False)
    assert tsc.deploy_from_dse(res).policy.name == "optimized"
