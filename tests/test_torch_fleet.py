"""The port's router and fleet (``repro_torch.serve.router``,
``repro_torch.launch.fleet``, ``costmodel.merge_queue_stats``) against the
JAX package's.

``tests/test_fleet.py``'s scenarios go through both packages: the hash
ring's lookups are the same for the same nodes and keys, and with
``execute=False`` (routing, fault injection, failover, preemption and
autoscaling on the virtual timebase; no card) the fleet's replayable JSON,
admission log, shipped metrics and Chrome-trace events are equal, not
close. The executed failover runs on the CPU (``device="cpu"``): its
outputs within ``tests/test_kernels.py``'s f32 tolerance of the JAX
fleet's (interpret mode), and the same bits as the port's own single
server and as the port's streamed fleet. Process-wide counters are read
as deltas around each run, never as totals.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import costmodel as jcm
from repro.launch import fleet as jfl
from repro.serve import cluster as jsc
from repro.serve import router as jrt
from repro_torch import obs as tobs
from repro_torch.core import costmodel as tcm
from repro_torch.core import scheduler as tsched
from repro_torch.core.stream_exec import StreamMesh
from repro_torch.launch import fleet as tfl
from repro_torch.serve import cluster as tsc
from repro_torch.serve import router as trt

JD, TD = jcm.DataflowClass, tcm.DataflowClass
KEYS = [f"tenant{i:03d}" for i in range(200)]
FLEET_COUNTERS = ("fleet.batches", "fleet.requeued",
                  "fleet.preempted_deferrals", "fleet.replicas_killed",
                  "fleet.scale_ups", "fleet.scale_downs")
#: (package's costmodel, DataflowClass, serve.cluster, launch.fleet, obs)
JAX = (jcm, JD, jsc, jfl, jobs)
PORT = (tcm, TD, tsc, tfl, tobs)


def small_aespa(pkg_cm, cls_enum, hbm_bw=math.inf):
    return pkg_cm.AcceleratorConfig(
        "aespa_small",
        tuple(pkg_cm.basic_cluster(c, 64) for c in (
            cls_enum.GEMM, cls_enum.SPMM, cls_enum.SPGEMM_INNER,
            cls_enum.SPGEMM_OUTER, cls_enum.SPGEMM_GUSTAVSON)),
        hbm_bw)


def contended_trace(sc, n=20, seed=1, gap=1500.0, **kw):
    return sc.generate_trace(n, seed=seed, mean_gap_cycles=gap, **kw)


def deltas(o, before):
    after = o.METRICS.snapshot()["counters"]
    return {k: after.get(k, 0.0) - before.get(k, 0.0)
            for k in FLEET_COUNTERS}


def fleet_run(pkg, trace_kw=None, plan=None, trace_fn=None, **fleet_kw):
    """One ``execute=False`` fleet serve in one package: its result and
    the ``fleet.*`` counter deltas of the run. ``plan`` maps the
    package's ``FaultPlan`` to a plan; ``trace_fn`` rewrites the trace."""
    cm, D, sc, fl, o = pkg
    trace = contended_trace(sc, **(trace_kw or {}))
    if trace_fn is not None:
        trace = trace_fn(trace)
    if plan is not None:
        fleet_kw["fault_plan"] = plan(fl.FaultPlan)
    before = o.METRICS.snapshot()["counters"]
    fr = fl.FleetServer(small_aespa(cm, D), **fleet_kw).run_trace(
        trace, execute=False)
    return fr, deltas(o, before)


def shipped(snapshot):
    """A shipped registry snapshot without the JAX registry's histograms
    (none is ever observed), which the port's registry does not have."""
    assert snapshot.get("histograms", {}) == {}
    return {k: v for k, v in snapshot.items() if k != "histograms"}


def outcome_view(fl, fr):
    """Everything of a ``FleetResult`` of the package whose fleet module is
    ``fl`` that is plain values: the JSON, admission log, shipped
    snapshots and per-replica admissions."""
    return {
        "json": json.dumps(fl.fleet_result_to_json(fr), sort_keys=True),
        "admission_log": [dataclasses.asdict(e) for e in fr.admission_log],
        "metrics_timeline": [(t, rid, shipped(snap))
                             for t, rid, snap in fr.metrics_timeline],
        "replicas": [(ro.rid, ro.index, ro.alive, ro.draining,
                      ro.death_cycles, ro.stall_cycles, ro.spawned_cycles,
                      ro.n_batches, ro.admitted, len(ro.retired),
                      None if ro.schedule is None
                      else ro.schedule.makespan_cycles)
                     for ro in fr.replicas],
        "aggregate": fr.aggregate_metrics(),
    }


def both(**kw):
    """The same fleet serve in both packages; asserts their views and
    counter deltas equal and returns the port's result."""
    jfr, jd = fleet_run(JAX, **kw)
    tfr, td = fleet_run(PORT, **kw)
    assert outcome_view(tfl, tfr) == outcome_view(jfl, jfr)
    assert td == jd
    return tfr, td


def oracle_check(fr, cfg, trace, policy):
    """``tests/test_fleet.py``'s oracle on the port: every surviving
    replica's final schedule equals the port's offline
    ``schedule_many_kernels`` on its admitted (task, release) pairs."""
    by_id = {r.request_id: r for r in trace}
    checked = 0
    for ro in fr.replicas:
        if not ro.alive or not ro.admitted:
            continue
        idxs = [i for i, _, _ in ro.admitted]
        assert idxs == list(range(len(idxs)))
        off = tsched.schedule_many_kernels(
            cfg, [by_id[rid].workload for _, rid, _ in ro.admitted],
            policy=policy, arrivals=[adm for _, _, adm in ro.admitted])
        assert ro.schedule.makespan_cycles == off.makespan_cycles
        by_idx = {a.task_index: a for a in off.assignments}
        for a in ro.schedule.assignments:
            assert a.placed == by_idx[a.task_index].placed
        checked += 1
    assert checked >= 1


# ------------------------------------------------------------- the ring
def test_stable_hash_matches_jax():
    for k in KEYS + ["replica0#0", "", "ünïcode"]:
        assert trt.stable_hash(k) == jrt.stable_hash(k)


@pytest.mark.parametrize("n,vnodes", [(1, 1), (3, 64), (5, 7), (9, 96)])
def test_ring_lookups_match_jax_under_insertion_order(n, vnodes):
    nodes = [f"replica{i}" for i in range(n)]
    t = trt.HashRing(nodes, vnodes=vnodes)
    j = jrt.HashRing(nodes, vnodes=vnodes)
    r = trt.HashRing(list(reversed(nodes)), vnodes=vnodes)
    assert t.nodes == j.nodes == r.nodes and len(t) == n
    for k in KEYS:
        assert t.lookup(k) == j.lookup(k) == r.lookup(k)


@pytest.mark.parametrize("n,victim,vnodes", [(2, 0, 1), (3, 1, 64),
                                             (6, 4, 13), (9, 8, 96)])
def test_ring_add_and_remove_move_keys_as_jax(n, victim, vnodes):
    """Adding a node moves keys only onto it, and at most about
    |keys|/(n+1); removing one moves only its keys; both packages agree
    after every change."""
    nodes = [f"replica{i}" for i in range(n)]
    t = trt.HashRing(nodes, vnodes=vnodes)
    j = jrt.HashRing(nodes, vnodes=vnodes)
    before = {k: t.lookup(k) for k in KEYS}
    t.add("replica_new")
    j.add("replica_new")
    moved = 0
    for k in KEYS:
        after = t.lookup(k)
        assert after == j.lookup(k)
        if after != before[k]:
            assert after == "replica_new"
            moved += 1
    assert moved <= len(KEYS) * 2 / (n + 1) + 10
    before = {k: t.lookup(k) for k in KEYS}
    gone = nodes[victim]
    t.remove(gone)
    j.remove(gone)
    for k in KEYS:
        after = t.lookup(k)
        assert after == j.lookup(k) and after != gone
        if before[k] != gone:
            assert after == before[k]


def test_ring_and_router_edge_cases_match_jax():
    for rt in (trt, jrt):
        ring = rt.HashRing()
        with pytest.raises(LookupError, match="empty"):
            ring.lookup("anyone")
        ring.add("only")
        assert all(ring.lookup(k) == "only" for k in KEYS)
        with pytest.raises(ValueError, match="already on the ring"):
            ring.add("only")
        with pytest.raises(KeyError, match="not on the ring"):
            ring.remove("ghost")
        assert "only" in ring and len(ring) == 1
        with pytest.raises(ValueError, match="vnodes must be >= 1"):
            rt.HashRing(vnodes=0)
    routers = [rt.Router(["replica0", "replica1", "replica2"])
               for rt in (trt, jrt)]
    owners = {k: routers[0].route(k) for k in KEYS}
    assert owners == {k: routers[1].route(k) for k in KEYS}
    for r in routers:
        r.remove_replica("replica1")
        assert r.replicas == ("replica0", "replica2")
        for k in KEYS:
            assert r.route(k) != "replica1"
            if owners[k] != "replica1":
                assert r.route(k) == owners[k]
        r.add_replica("replica3")
    assert ({k: routers[0].route(k) for k in KEYS}
            == {k: routers[1].route(k) for k in KEYS})


def test_router_snapshot_aggregation_matches_jax():
    snaps = [(10.0, "replica0", {"counters": {"replica.admitted": 3},
                                 "gauges": {"replica.queue_depth": 2.0}}),
             (12.0, "replica1", {"counters": {"replica.admitted": 4},
                                 "gauges": {"replica.queue_depth": 1.0}}),
             (20.0, "replica0", {"counters": {"replica.admitted": 7},
                                 "gauges": {"replica.queue_depth": 0.0}})]
    aggs = []
    for rt in (trt, jrt):
        r = rt.Router(["replica0", "replica1"])
        for snap in snaps:
            r.record_snapshot(*snap)
        agg = r.aggregate_metrics()
        assert agg == rt.aggregate_snapshots(r.metrics_timeline)
        assert r.latest_snapshots()["replica0"] == snaps[2][2]
        aggs.append(agg)
    assert aggs[0] == aggs[1]
    assert aggs[0]["counters"]["replica.admitted"] == 11
    assert aggs[0]["counters"]["fleet.queue_depth"] == 1.0
    assert trt.aggregate_snapshots([]) == jrt.aggregate_snapshots([])


# --------------------------------------------------- merged queue stats
def test_merge_queue_stats_matches_jax():
    jcfg, tcfg = small_aespa(jcm, JD), small_aespa(tcm, TD)
    n = len(tcfg.clusters)
    kw = dict(wait_cycles=[0.0, 10.0, 4.0],
              turnaround_cycles=[100.0, 120.0, 90.0], makespan_cycles=200.0,
              queue_depth=2, finish_cycles=[100.0, 130.0, 250.0],
              deadline_cycles=[150.0, None, 200.0])
    merged = [cm.merge_queue_stats([(cfg, [100.0] * n),
                                    (cfg, [50.0 + i for i in range(n)])],
                                   **kw)
              for cm, cfg in ((tcm, tcfg), (jcm, jcfg))]
    assert merged[0].to_json() == merged[1].to_json()
    assert len(merged[0].busy_cycles) == 2 * n
    assert 0.0 < merged[0].utilization <= 1.0
    assert merged[0].deadline_misses == 1
    for args in (([], [], [], 0.0), ("cfg-short",)):
        errs = []
        for cm, cfg in ((tcm, tcfg), (jcm, jcfg)):
            a = ([(cfg, [1.0])], [], [], 0.0) if args == ("cfg-short",) \
                else args
            with pytest.raises(ValueError) as ei:
                cm.merge_queue_stats(*a)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


# ---------------------------------------------- fleets with execute=False
@pytest.mark.parametrize("policy", ["lpt", "sjf", "affinity", "optimized"])
def test_one_replica_fleet_matches_jax_and_cluster_server(policy):
    fr, _ = both(trace_kw=dict(n=15), n_replicas=1, policy=policy,
                 batch_window_cycles=3000.0)
    trace = contended_trace(tsc, 15)
    sr = tsc.ClusterServer(small_aespa(tcm, TD), policy=policy,
                           batch_window_cycles=3000.0).run_trace(
                               trace, execute=False)
    assert [(r.request.request_id, r.batch_id, r.admitted_cycles,
             r.start_cycles, r.finish_cycles) for r in sr.results] == [
        (r.request.request_id, r.batch_id, r.admitted_cycles,
         r.start_cycles, r.finish_cycles) for r in fr.records]
    assert fr.report.stats.p99_wait_cycles == sr.report.stats.p99_wait_cycles


def test_one_replica_with_depth_gate_matches_jax():
    both(trace_kw=dict(n=15, gap=800.0), n_replicas=1, policy="sjf",
         batch_window_cycles=2000.0, max_queue_depth=3)


@pytest.mark.parametrize("plan_name,plan", [
    ("die_before_admit", lambda F: F.kill_before_admit(0, batch=1)),
    ("die_mid_batch", lambda F: F.kill_mid_batch(0, batch=1)),
    ("stall_then_recover", lambda F: F.stall(0, 4000.0, 25_000.0)),
])
@pytest.mark.parametrize("policy", ["sjf", "optimized"])
def test_fault_plans_match_jax_and_the_offline_oracle(plan_name, plan,
                                                      policy):
    fr, d = both(trace_kw=dict(n=18, seed=4), plan=plan, n_replicas=2,
                 policy=policy, batch_window_cycles=2500.0)
    assert fr.report.n_requests == 18
    oracle_check(fr, small_aespa(tcm, TD),
                 contended_trace(tsc, 18, seed=4), policy)
    if plan_name == "stall_then_recover":
        assert fr.report.n_replicas_live == 2
        assert fr.report.per_replica[0].stall_cycles == 25_000.0
        assert d["fleet.replicas_killed"] == 0
    else:
        assert fr.report.n_replicas_live == 1
        assert d["fleet.replicas_killed"] == 1
        assert d["fleet.requeued"] == sum(
            f.n_requeued for f in fr.fault_log if f.kind == "kill")


@pytest.mark.parametrize("seed,n_replicas,kill_frac", [
    (0, 2, 0.05), (17, 3, 0.5), (4242, 4, 0.95), (9001, 2, 0.7)])
def test_kill_at_requeues_exactly_once_as_jax(seed, n_replicas, kill_frac):
    trace = contended_trace(tsc, 20, seed=seed)
    horizon = max(r.arrival_cycles for r in trace) / kill_frac
    fr, _ = both(trace_kw=dict(n=20, seed=seed), n_replicas=n_replicas,
                 plan=lambda F: F.kill_at(0, horizon * kill_frac),
                 failover_detect_cycles=500.0)
    ids = [r.request.request_id for r in fr.records]
    assert sorted(ids) == sorted(r.request_id for r in trace)
    for rec in fr.records:
        if rec.requeued:
            assert rec.replica != "replica0"
    assert fr.report.requeued_requests == sum(
        r.requeued > 0 for r in fr.records)


def test_slow_fault_and_sla_attribution_match_jax():
    trace = contended_trace(tsc, 16, seed=9, gap=1200.0,
                            deadline_slack_cycles=20_000.0)
    kill_t = trace[len(trace) // 2].arrival_cycles
    fr, _ = both(trace_kw=dict(n=16, seed=9, gap=1200.0,
                               deadline_slack_cycles=20_000.0),
                 n_replicas=2,
                 plan=lambda F: F(F.kill_at(0, kill_t).events()
                                  + F.slow(1, 2000.0, 10_000.0,
                                           700.0).events()),
                 failover_detect_cycles=60_000.0)
    assert fr.report.requeued_requests >= 1
    assert fr.report.sla_misses_failover >= 1
    assert any(r.fault_delayed for r in fr.records)
    assert (fr.report.sla_misses_failover + fr.report.sla_misses_tenant
            == fr.report.sla_misses_total)


def test_all_replicas_dead_raises_as_jax():
    for pkg in (PORT, JAX):
        with pytest.raises(RuntimeError, match="nothing left to fail over"):
            fleet_run(pkg, trace_kw=dict(n=8), n_replicas=1,
                      plan=lambda F: F.kill_at(0, 1.0))


def test_preemption_matches_jax():
    prio = lambda tr: [dataclasses.replace(r, priority=i % 3)  # noqa: E731
                       for i, r in enumerate(tr)]
    fr, d = both(trace_kw=dict(n=30, seed=5, gap=200.0), trace_fn=prio,
                 n_replicas=1, batch_window_cycles=1000.0, preempt_depth=2)
    deferred = [ev for ev in fr.admission_log if ev.deferred]
    assert deferred
    for ev in deferred:
        assert min(p for _, p in ev.admitted) >= max(
            p for _, p in ev.deferred)
    assert d["fleet.preempted_deferrals"] == fr.report.preempted_deferrals > 0


def test_autoscaler_scale_up_matches_jax():
    fr, d = both(trace_kw=dict(n=30, seed=3, gap=200.0), n_replicas=1,
                 batch_window_cycles=1500.0,
                 autoscaler=tfl.Autoscaler(high_water=3, low_water=0,
                                           max_replicas=4))
    ups = [s for s in fr.scale_log if s.action == "up"]
    assert ups and all(s.queue_depth >= 3 for s in ups)
    assert fr.report.n_replicas_launched == 1 + len(ups)
    assert d["fleet.scale_ups"] == len(ups)
    assert d["fleet.batches"] == fr.report.n_batches


def test_autoscaler_decisions_and_validation_match_jax():
    for high in (2, 5, 50):
        for low in (0, 1):
            a = tfl.Autoscaler(high, low, min_replicas=1, max_replicas=8)
            b = jfl.Autoscaler(high, low, min_replicas=1, max_replicas=8)
            for depth in range(0, 60, 3):
                for n_live in range(1, 9):
                    assert a.decide(depth, n_live) == b.decide(depth,
                                                               n_live)
    for kw in (dict(high_water=2, low_water=2),
               dict(high_water=5, low_water=1, min_replicas=0),
               dict(high_water=5, low_water=1, min_replicas=4,
                    max_replicas=2)):
        msgs = []
        for fl in (tfl, jfl):
            with pytest.raises(ValueError) as ei:
                fl.Autoscaler(**kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_validation_errors_match_jax():
    def err(fn):
        with pytest.raises((ValueError, RuntimeError)) as ei:
            fn()
        return type(ei.value), str(ei.value)

    cases = [
        lambda fl, c, sc: fl.FaultEvent(0, "explode", at_cycles=1.0),
        lambda fl, c, sc: fl.FaultEvent(0, "kill", at_cycles=1.0,
                                        at_batch=0),
        lambda fl, c, sc: fl.FaultEvent(0, "kill"),
        lambda fl, c, sc: fl.FaultEvent(0, "stall", at_batch=0),
        lambda fl, c, sc: fl.FaultEvent(0, "kill", at_cycles=1.0,
                                        phase="sometime"),
        lambda fl, c, sc: fl.FleetServer(c, n_replicas=0),
        lambda fl, c, sc: fl.FleetServer(c, preempt_depth=0),
        lambda fl, c, sc: fl.FleetServer(c, failover_detect_cycles=-1.0),
        lambda fl, c, sc: fl.FleetServer(c, snapshot_every_batches=0),
        lambda fl, c, sc: fl.FleetServer(
            c, backend="subprocess", fault_plan=fl.FaultPlan.kill_at(0, 1)),
        lambda fl, c, sc: fl.FleetServer(c, backend="threads"),
        lambda fl, c, sc: fl.FleetServer(c, batch_window_cycles=-1.0),
        lambda fl, c, sc: fl.FleetServer(
            c, n_replicas=2, fault_plan=fl.FaultPlan.kill_at(5, 1.0)
        ).run_trace(contended_trace(sc, 3), execute=False),
        lambda fl, c, sc: fl.FleetServer(
            c, fault_plan=fl.FaultPlan(
                fl.FaultPlan.kill_before_admit(0, 1).events() * 2)
        ).run_trace(contended_trace(sc, 3), execute=False),
        lambda fl, c, sc: fl.FleetServer(c, n_replicas=2,
                                         backend="subprocess").run_trace(
            contended_trace(sc, 3), execute=True),
        lambda fl, c, sc: fl.FleetServer(c).run_trace(
            contended_trace(sc, 3), execute=False,
            trace_flush_every_batches=0),
        lambda fl, c, sc: fl.FleetServer(c).run_trace(
            contended_trace(sc, 2) * 2, execute=False),
    ]
    for case in cases:
        assert err(lambda: case(tfl, small_aespa(tcm, TD), tsc)) == err(
            lambda: case(jfl, small_aespa(jcm, JD), jsc))


def test_fleet_ships_and_aggregates_replica_snapshots_as_jax():
    fr, _ = both(trace_kw=dict(n=12, seed=2), n_replicas=2,
                 snapshot_every_batches=2)
    assert {rid for _, rid, _ in fr.metrics_timeline} == {"replica0",
                                                          "replica1"}
    agg = fr.aggregate_metrics()
    assert agg["counters"]["replica.admitted"] == 12
    assert agg["counters"]["replica.batches"] == fr.report.n_batches


# ---------------------------------------------------------- trace export
def test_fleet_trace_events_match_jax(tmp_path):
    jfr, _ = fleet_run(JAX, trace_kw=dict(n=10, seed=6), n_replicas=2,
                       plan=lambda F: F.kill_at(0, 20_000.0))
    tfr, _ = fleet_run(PORT, trace_kw=dict(n=10, seed=6), n_replicas=2,
                       plan=lambda F: F.kill_at(0, 20_000.0))
    tev, tnames = tfl.fleet_trace_events(tfr)
    jev, jnames = jfl.fleet_trace_events(jfr)
    assert tev == jev and tnames == jnames
    assert tfl.PID_FLEET_ROUTER == jfl.PID_FLEET_ROUTER
    assert tfl.PID_FLEET_BASE == jfl.PID_FLEET_BASE
    assert any("replica0" in n and "killed" in n for n in tnames.values())
    pt = tfr.export_chrome_trace(tmp_path / "t.json")
    pj = jfr.export_chrome_trace(tmp_path / "j.json")
    assert pt.read_text() == pj.read_text()
    runs = [e for e in json.loads(pt.read_text())["traceEvents"]
            if e.get("cat") == "request" and e["name"] == "run"]
    assert len(runs) == 10


def test_windowed_trace_flush_matches_jax(tmp_path):
    counts = []
    for pkg in (PORT, JAX):
        cm, D, sc, fl, o = pkg
        out = tmp_path / fl.__name__
        out.mkdir()
        o.TRACE.reset()
        o.enable()
        try:
            fr = fl.FleetServer(small_aespa(cm, D), n_replicas=2).run_trace(
                contended_trace(sc, 10, seed=6), execute=False,
                trace_flush_dir=out, trace_flush_every_batches=3)
        finally:
            o.disable()
            o.TRACE.reset()
        for p in fr.trace_windows:
            assert "traceEvents" in json.loads(p.read_text())
        counts.append(len(fr.trace_windows))
    assert counts[0] == counts[1] >= 2


# ------------------------------------------------------- executed fleets
@pytest.fixture(scope="module")
def executed():
    """``tests/test_fleet.py``'s executed failover in both packages (JAX
    in interpret mode, the port on the CPU), the port's single server on
    the same trace, and the port's fleet on ``StreamMesh(8)``."""
    kw = dict(n_replicas=2, policy="affinity")
    jtr = contended_trace(jsc, 6, seed=11, gap=2000.0)
    ttr = contended_trace(tsc, 6, seed=11, gap=2000.0)
    jfr = jfl.FleetServer(small_aespa(jcm, JD),
                          fault_plan=jfl.FaultPlan.kill_mid_batch(0, 0),
                          **kw).run_trace(jtr, interpret=True, block=64)
    tcfg = small_aespa(tcm, TD)
    tfr = tfl.FleetServer(tcfg, fault_plan=tfl.FaultPlan.kill_mid_batch(0, 0),
                          **kw).run_trace(ttr, block=64, device="cpu")
    sr = tsc.ClusterServer(tcfg, policy="affinity").run_trace(
        ttr, block=64, device="cpu")
    st = tfl.FleetServer(tcfg, fault_plan=tfl.FaultPlan.kill_mid_batch(0, 0),
                         **kw).run_trace(
        ttr, block=64, mesh=StreamMesh(8, device="cpu"), pipeline_depth=2)
    return jfr, tfr, sr, st


def test_executed_failover_matches_jax_and_a_single_server(executed):
    jfr, tfr, sr, _ = executed
    assert (json.dumps(tfl.fleet_result_to_json(tfr), sort_keys=True)
            == json.dumps(jfl.fleet_result_to_json(jfr), sort_keys=True))
    assert any(rec.requeued for rec in tfr.records)
    assert tfr.report.n_replicas_live == 1
    single = {r.request.request_id: r.output for r in sr.results}
    for j, t in zip(jfr.records, tfr.records):
        assert isinstance(t.output, torch.Tensor)
        assert t.output.device.type == "cpu"
        a, b = tsc.request_operands(t.request)
        got = t.output.numpy()
        np.testing.assert_allclose(got, np.asarray(j.output), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
        assert torch.equal(t.output, single[t.request.request_id])


def test_streamed_fleet_bit_equal_to_sequential(executed):
    _, tfr, _, st = executed
    assert (tfl.fleet_result_to_json(st) == tfl.fleet_result_to_json(tfr))
    for a, b in zip(tfr.records, st.records):
        assert a.request.request_id == b.request.request_id
        assert torch.equal(a.output, b.output)


def test_fleet_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve() runs on it")
    tcfg = small_aespa(tcm, TD)
    trace = contended_trace(tsc, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfl.FleetServer(tcfg).run_trace(trace)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfl.FleetServer(tcfg).run_trace(trace, mesh=StreamMesh(8))
    with pytest.raises(ValueError, match="mesh= is on"):
        tfl.FleetServer(tcfg).run_trace(
            trace, mesh=StreamMesh(8, device="cpu"), device="cuda")
    assert tfl.FleetServer(tcfg).run_trace(trace,
                                           execute=False).records


# ---------------------------------------------------- subprocess backend
def test_subprocess_backend_matches_inproc_routing():
    """Static fault-free fleet: the port's subprocess workers give the
    same replica and times per request as its in-process backend and as
    the JAX package's, and the children's metrics ship to the router."""
    tcfg = small_aespa(tcm, TD)
    kw = dict(n_replicas=2, batch_window_cycles=2000.0)
    trace = contended_trace(tsc, 10, seed=8)
    fi = tfl.FleetServer(tcfg, **kw).run_trace(trace, execute=False)
    fs = tfl.FleetServer(tcfg, backend="subprocess", **kw).run_trace(
        trace, execute=False)
    fj = jfl.FleetServer(small_aespa(jcm, JD), **kw).run_trace(
        contended_trace(jsc, 10, seed=8), execute=False)
    ref = {r.request.request_id: r for r in fi.records}
    jref = {r.request.request_id: r for r in fj.records}
    assert len(fs.records) == 10
    for rec in fs.records:
        for other in (ref, jref):
            o = other[rec.request.request_id]
            assert (rec.replica, rec.batch_id, rec.admitted_cycles,
                    rec.start_cycles, rec.finish_cycles) == (
                o.replica, o.batch_id, o.admitted_cycles, o.start_cycles,
                o.finish_cycles)
    assert fs.aggregate_metrics()["counters"]["serve.admitted"] == 10
    assert fs.report.stats.busy_cycles == fi.report.stats.busy_cycles


def test_subprocess_worker_imports_neither_jax_nor_repro():
    """The worker source, run as the fleet runs it, serves its share and
    ends with neither ``jax`` nor ``repro`` imported and no CUDA context."""
    tcfg = small_aespa(tcm, TD)
    spec = {"config": tcm.config_to_json(tcfg), "policy": "sjf",
            "batch_window_cycles": 0.0, "max_queue_depth": None,
            "trace": tsc.trace_to_json(contended_trace(tsc, 4, seed=3))}
    check = (
        "\nbad = sorted(n for n in sys.modules if n in ('jax', 'repro') or"
        " n.startswith(('jax.', 'repro.')))\n"
        "import torch\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(tfl.__file__).resolve().parents[2])
    proc = subprocess.run([sys.executable, "-c", tfl._WORKER_SRC + check],
                          input=json.dumps(spec), capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["results"]) == 4
    assert out["metrics"]["counters"]["serve.admitted"] == 4
