"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the same calls on both registries and tracers
give equal snapshots and equal Chrome-trace JSON; the port's
``OnlineScheduler`` with tracing on emits the same offer, dispatch and
defer events as JAX's on the same offers; ``dse.search`` bumps the same
counters. The port's registry and tracer are objects of their own.
"""
import json
import math

import pytest

from repro import obs as jobs
from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import workloads as jwl
from repro.serve import cluster as jsc
from repro_torch import obs as tobs
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.serve import cluster as tsc

BOTH = (jobs, tobs)


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Every test starts and ends with tracing off and empty buffers."""
    for o in BOTH:
        o.disable()
        o.TRACE.reset()
    yield
    for o in BOTH:
        o.disable()
        o.TRACE.reset()


def twin(jw):
    return twl.Workload(jw.name, jw.application, jw.m, jw.k, jw.n, jw.d_mk,
                        jw.d_kn)


def test_registries_and_tracers_are_the_ports_own():
    assert tobs.TRACE is not jobs.TRACE
    assert tobs.METRICS is not jobs.METRICS
    jobs.enable()
    assert not tobs.enabled()
    tobs.TRACE.instant("x", 1.0)
    assert tobs.TRACE.events() == []


def record(o, tr):
    """A fixed script of recording calls (no wall-clock spans)."""
    tr.complete("span_a", 10.0, 5.0, pid=o.PID_VIRTUAL, tid="rowB",
                cat="test", k=1)
    tr.complete("span_b", 0.0, -2.0, pid=o.PID_VIRTUAL, tid="rowA")
    tr.instant("mark", 3.0, pid=o.PID_VIRTUAL, tid="rowA", note="x")
    tr.counter("depth", 2.0, 4.0, pid=o.PID_VIRTUAL, tid="rowA")
    tr.counter("multi", None, 5.0, pid=o.PID_HOST, tid=3, a=1.0, b=2.0)
    tr.complete("m", 7.0, 1.0, pid=o.PID_MEASURED, tid="cluster0[dev0:2]")
    tr.name_thread(o.PID_HOST, 3, "host three")
    tr.name_process(9, "replica 9")
    tr.instant("other", 1.5, pid=9, tid=0)


@pytest.mark.parametrize("capacity", [3, 100])
def test_tracer_chrome_trace_matches_jax(capacity, tmp_path):
    docs = []
    for o in BOTH:
        tr = o.Tracer(capacity=capacity)
        prev = o.enable()
        try:
            record(o, tr)
        finally:
            o.enable(prev)
        docs.append((tr.chrome_trace(), tr.dropped,
                     tr.export_chrome_trace(tmp_path / f"{o.__name__}.json")
                     .read_text()))
    assert docs[0] == docs[1]


def test_write_chrome_trace_and_flush_match_jax(tmp_path):
    out = []
    for i, o in enumerate(BOTH):
        events = [{"ph": "X", "name": "a", "ts": 1.0, "dur": 2.0,
                   "pid": o.PID_VIRTUAL, "tid": "r"},
                  {"ph": "i", "s": "t", "name": "b", "ts": 0.5,
                   "pid": o.PID_HOST, "tid": 0}]
        p = o.write_chrome_trace(tmp_path / f"w{i}.json", events,
                                 thread_names={(o.PID_HOST, 0): "h"},
                                 process_names={7: "seven"})
        tr = o.Tracer()
        prev = o.enable()
        try:
            record(o, tr)
        finally:
            o.enable(prev)
        fp, n = tr.flush(tmp_path / f"f{i}.json")
        out.append((p.read_text(), fp.read_text(), n, tr.events()))
    assert out[0] == out[1]


def test_tracer_disabled_is_inert_and_span_records_wall_time():
    tr = tobs.Tracer()
    tr.complete("x", 0.0, 1.0)
    tr.instant("y")
    tr.counter("z", 1.0)
    s = tr.span("w")
    with s:
        pass
    assert s is tr.span("w2") and tr.events() == []
    prev = tobs.enable()
    try:
        with tr.span("wall", tid="t", arg=1):
            pass
    finally:
        tobs.enable(prev)
    (ev,) = tr.events()
    assert ev["ph"] == "X" and ev["pid"] == tobs.PID_HOST
    assert ev["dur"] >= 0.0 and ev["args"] == {"arg": 1}


def test_metrics_registry_matches_jax(tmp_path):
    """Counters, gauges and callbacks; the JAX registry's histograms,
    which the port left out, are dropped from its side."""
    snaps = []
    for o in BOTH:
        reg = o.MetricsRegistry()
        c, g = reg.counter("c"), reg.gauge("g")
        c.inc()
        c.inc(2.5)
        g.set(7)
        g.dec(3)
        g.inc(0.5)
        reg.register_callback("ext", lambda: {"k": 42})
        reg.register_callback("bad", lambda: 1 / 0)
        first = reg.snapshot()
        p = reg.export_json(tmp_path / f"{o.__name__}.json")
        reg.reset()
        docs = [first, reg.snapshot(), json.loads(p.read_text()),
                reg.to_json()]
        if o is jobs:
            for d in docs:
                assert d.pop("histograms") == {}
        snaps.append(docs)
    assert snaps[0] == snaps[1]
    assert not hasattr(tobs, "Histogram") and not hasattr(
        tobs.MetricsRegistry, "histogram")


# --------------------------------------------------- scheduler trace hooks
def scheduler_events(o, sched_mod, cfg, tasks, policy, arrivals):
    """Drive an engine the way the server does (bounded advances between
    offers) with tracing on; return its events and counter deltas."""
    names = ("scheduler.offers", "scheduler.placements",
             "scheduler.deferrals")
    before = o.METRICS.snapshot()["counters"]
    o.TRACE.reset()
    o.enable()
    try:
        eng = sched_mod.OnlineScheduler(cfg, policy)
        for i, (w, a) in enumerate(zip(tasks, arrivals)):
            eng.advance(until=a)
            eng.offer(w, arrival=a, index=i)
        eng.drain()
        ms = eng.finish()
    finally:
        o.disable()
    after = o.METRICS.snapshot()
    events = o.TRACE.events()
    o.TRACE.reset()
    deltas = {n: after["counters"][n] - before.get(n, 0.0) for n in names}
    return events, deltas, ms, after["derived"]


@pytest.mark.parametrize("policy", ["lpt", "sjf", "affinity", "optimized"])
def test_online_scheduler_trace_events_match_jax(policy):
    jtasks = list(jwl.TABLE_I) * 2
    arrivals = [i * 150_000.0 for i in range(len(jtasks))]
    jev, jd, jms, _ = scheduler_events(jobs, jsched, jdse.aespa_equal4(),
                                       jtasks, policy, arrivals)
    tev, td, tms, derived = scheduler_events(
        tobs, tsched, tdse.aespa_equal4(), [twin(w) for w in jtasks],
        policy, arrivals)
    assert tev == jev
    assert td == jd
    assert td["scheduler.offers"] == len(jtasks)
    assert td["scheduler.placements"] == len(jtasks)
    assert td["scheduler.deferrals"] > 0
    assert {e["name"] for e in tev} >= {"offer", "dispatch", "defer",
                                        "queue_depth"}
    assert tms.makespan_cycles == jms.makespan_cycles
    assert set(derived["scheduler.caches"]) == set(
        tsched.schedule_cache_info())


def test_tracing_does_not_change_serve_results():
    """The same trace served with the port's tracing on and off gives the
    same JSON, equal to JAX's; the admission counters and the admission
    window events match JAX's."""
    def run(sc, cm_, wl, o, on):
        D = cm_.DataflowClass
        cfg = cm_.aespa_from_fractions(
            {D.GEMM: 0.5, D.SPMM: 0.3, D.SPGEMM_INNER: 0.2},
            name="obs_test")
        reqs = [sc.Request(f"r{i:02d}", f"tenant{i % 3}", w,
                           arrival_cycles=i * 2e4,
                           deadline_cycles=(i * 2e4 + 5e7 if i % 2
                                            else None), seed=i)
                for i, w in enumerate((list(wl.TABLE_I) * 2)[:8])]
        before = o.METRICS.snapshot()["counters"]
        o.enable(on)
        try:
            sr = sc.ClusterServer(cfg, policy="optimized",
                                  batch_window_cycles=5e4,
                                  max_queue_depth=4).run_trace(
                reqs, execute=False)
        finally:
            o.disable()
        after = o.METRICS.snapshot()["counters"]
        events = [e for e in o.TRACE.events() if e.get("cat") == "serve"]
        o.TRACE.reset()
        return (sc.serve_result_to_json(sr), events,
                {k: after[k] - before.get(k, 0.0) for k in (
                    "serve.admitted", "serve.batches",
                    "serve.backpressure_deferrals")})

    t_off = run(tsc, tcm, twl, tobs, False)
    t_on = run(tsc, tcm, twl, tobs, True)
    j_on = run(jsc, jcm, jwl, jobs, True)
    assert t_off[0] == t_on[0]
    assert json.dumps(t_on[0], sort_keys=True) == json.dumps(
        j_on[0], sort_keys=True)
    assert t_on[1] == j_on[1] and t_on[1]
    assert t_on[2] == j_on[2] == t_off[2]


def test_dse_search_bumps_the_same_counters_and_events():
    """A small two-stage search: the same evaluation and improvement
    counts in both registries, and the same incumbent events (the eval
    batches carry wall times, so only their count and sizes compare).
    The ``dse_evals`` counter events carry the process-wide running
    total, which grows with every search run before in the same process;
    each package's totals are read relative to its ``dse.evaluations``
    before this search, so only this search's evaluations compare."""
    suite = list(jwl.TABLE_I)[:4]
    classes_j = (jcm.DataflowClass.GEMM, jcm.DataflowClass.SPMM,
                 jcm.DataflowClass.SPGEMM_OUTER)
    out = []
    for o, dse_mod, cm_, tasks in ((jobs, jdse, jcm, suite),
                                   (tobs, tdse, tcm,
                                    [twin(w) for w in suite])):
        classes = tuple(cm_.DataflowClass(c.value) for c in classes_j)
        before = o.METRICS.snapshot()["counters"]
        o.enable()
        try:
            res = dse_mod.search(suite=tasks, hbm_bw=math.inf, step=0.5,
                                 classes=classes, with_baselines=False)
        finally:
            o.disable()
        after = o.METRICS.snapshot()["counters"]
        evs = o.TRACE.events()
        o.TRACE.reset()
        out.append((
            {k: after[k] - before.get(k, 0.0)
             for k in ("dse.evaluations", "dse.incumbent_improved")},
            [e for e in evs if e["name"] == "incumbent_improved"],
            [e["args"]["candidates"] for e in evs
             if e["name"] == "eval_batch"],
            [e["args"]["total"] - before.get("dse.evaluations", 0.0)
             for e in evs if e["name"] == "dse_evals"],
            res.evaluations))
    for counts, improved, *_ in out:
        for e in improved:
            e.pop("ts")             # host clock
    assert out[0] == out[1]
    assert out[1][0]["dse.evaluations"] >= out[1][4] > 0
