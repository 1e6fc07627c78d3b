"""The spans of the port's sequential queue path (``repro.queue``,
``repro.sync``, ``repro.schedule``, ``repro.task``, ``repro.convert``,
``repro.dispatch.<class>``, ``repro.merge``): off, a span site is the
shared null span and enters no profiler range; under a CPU
``torch.profiler`` they are ranges nested as the layers are, counted
from the schedule; with ``obs.enable()`` the ring buffer holds the same
spans with their ids; the outputs are the same bits either way.
Process-wide counters are compared by their deltas, never their totals.
"""
import collections
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import costmodel as cm
from repro_torch.core import dse
from repro_torch.core import hetero_matmul as hm
from repro_torch.formats.taxonomy import DataflowClass as D
from repro_torch.obs import trace as trace_mod

SPAN_NAMES = ("repro.queue", "repro.sync", "repro.schedule", "repro.task",
              "repro.convert", "repro.merge")


@pytest.fixture(autouse=True)
def _clean_tracer():
    obs.disable()
    obs.TRACE.reset()
    yield
    obs.disable()
    obs.TRACE.reset()


def small5():
    """Five 64-PE clusters, one of each class."""
    return cm.AcceleratorConfig(
        "aespa_small", tuple(cm.basic_cluster(c, 64) for c in (
            D.GEMM, D.SPMM, D.SPGEMM_INNER, D.SPGEMM_OUTER,
            D.SPGEMM_GUSTAVSON)), math.inf)


#: A dense straggler (``optimized`` splits it over all five clusters,
#: SpMM mirrored among them) beside sparse and mixed tasks.
SHAPES = [(96, 96, 96, 1.0, 1.0), (64, 80, 48, 0.1, 1.0),
          (48, 64, 64, 0.05, 0.05), (32, 32, 96, 0.5, 0.3),
          (48, 96, 64, 0.3, 0.02), (64, 64, 64, 0.9, 0.05)]

CASES = {"small5_lpt": (small5, "lpt"),
         "small5_optimized": (small5, "optimized"),
         "equal4_lpt": (dse.aespa_equal4, "lpt")}


def queue_pairs(seed=0):
    g = torch.Generator().manual_seed(seed)
    pairs = []
    for m, k, n, dmk, dkn in SHAPES:
        a = torch.randn(m, k, generator=g) * (
            torch.rand(m, k, generator=g) < dmk)
        b = torch.randn(k, n, generator=g) * (
            torch.rand(k, n, generator=g) < dkn)
        pairs.append((a, b))
    return pairs


def run(case, seed=0):
    make, policy = CASES[case]
    return hm.hetero_many_matmul(queue_pairs(seed), make(), policy=policy,
                                 block=32, device="cpu")


def partitions(asg):
    return [pp.partition for pp in asg.placed
            if not pp.partition.region.empty]


def compressed(p):
    return hm._compressed_operands(p.cls, p.mirror)


def expected_counts(ms):
    """Each span's count on one queue, from its schedule alone."""
    parts = [p for a in ms.assignments for p in partitions(a)]
    synced = sum(any(compressed(p) for p in partitions(a))
                 for a in ms.assignments)
    want = collections.Counter({
        "repro.queue": 1, "repro.schedule": 1,
        "repro.task": len(ms.assignments),
        "repro.sync": 1 + synced,
        "repro.convert": sum(len(compressed(p)) for p in parts),
        "repro.merge": len(ms.assignments)})
    want.update(f"repro.dispatch.{p.cls.value}" for p in parts)
    return want


def program_ranges(prof):
    """``[(name, start_us, end_us)]`` of the program's profiler ranges."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("repro.")]


def within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_off_are_the_null_span_and_enter_no_range(monkeypatch):
    """With neither obs nor a profiler on, every span site hands back the
    shared null span; a profiler range (``record_function`` or its fast
    form, which the tracer opens) that raises is never entered, so a
    whole queue runs through it."""
    def refuse(*args, **kw):
        raise AssertionError("profiler range entered with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    for name in SPAN_NAMES + ("repro.dispatch.gemm",):
        assert obs.TRACE.span(name, cat="queue", x=1) is trace_mod._NULL_SPAN
    outs, ms = run("small5_optimized")
    assert len(outs) == len(SHAPES) and obs.TRACE.events() == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_queue_spans_under_a_cpu_profiler(case):
    """One ``repro.queue`` enclosing the rest, one ``repro.schedule``, a
    ``repro.task`` and a ``repro.merge`` per task, a ``repro.sync`` for
    the densities and for each task with a compressed operand, a
    ``repro.convert`` per compressed operand and a
    ``repro.dispatch.<class>`` per partition, counted from the
    schedule; each nested in the span of the layer above it."""
    _, ms = run(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, ms2 = run(case)
    assert ([(a.task_index, a.cls) for a in ms2.assignments]
            == [(a.task_index, a.cls) for a in ms.assignments])
    ranges = program_ranges(prof)
    assert collections.Counter(r[0] for r in ranges) == expected_counts(ms)
    by = collections.defaultdict(list)
    for r in ranges:
        by[r[0]].append(r)
    (queue,) = by["repro.queue"]
    (sched,) = by["repro.schedule"]
    assert all(within(r, queue) for r in ranges)
    tasks = sorted(by["repro.task"], key=lambda r: r[1])
    assert not any(within(sched, t) for t in tasks)
    # The density fetch comes before the schedule, every task after it.
    first_sync = min(by["repro.sync"], key=lambda r: r[1])
    assert first_sync[2] <= sched[1] <= sched[2] <= tasks[0][1]
    for r in ranges:
        if r[0] in ("repro.queue", "repro.schedule", "repro.task"):
            continue
        owners = [t for t in tasks if within(r, t)]
        assert len(owners) == (0 if r is first_sync else 1), r
    # Each task's dispatches name its partitions' classes, in order.
    for asg, t in zip(ms.assignments, tasks):
        got = [r[0] for r in sorted(ranges, key=lambda r: r[1])
               if r[0].startswith("repro.dispatch.") and within(r, t)]
        assert got == [f"repro.dispatch.{p.cls.value}"
                       for p in partitions(asg)]


def test_obs_ring_buffer_holds_the_queue_spans_with_their_ids():
    """With ``obs.enable()`` the same spans land in the ring buffer as
    ``ph:"X"`` events on the host row, each task's carrying its queue's
    sequence number, its index and its class; two queues get
    consecutive numbers."""
    _, ms = run("small5_optimized")
    counters = ("scheduler.placements", "scheduler.offers")
    before = obs.METRICS.snapshot()["counters"]
    obs.enable()
    try:
        run("small5_optimized")
        run("small5_optimized", seed=1)
    finally:
        obs.disable()
    after = obs.METRICS.snapshot()["counters"]
    assert {k: after[k] - before.get(k, 0.0) for k in counters} == {
        k: 2.0 * len(SHAPES) for k in counters}
    spans = [e for e in obs.TRACE.events() if e.get("cat") == "queue"]
    assert all(e["ph"] == "X" and e["pid"] == obs.PID_HOST for e in spans)
    want = expected_counts(ms)
    assert collections.Counter(e["name"] for e in spans) == collections.Counter(
        {k: 2 * v for k, v in want.items()})
    queues = sorted((e for e in spans if e["name"] == "repro.queue"),
                    key=lambda e: e["ts"])
    q0, q1 = (e["args"]["queue"] for e in queues)
    assert q1 == q0 + 1
    assert queues[0]["args"] == {"queue": q0, "tasks": len(SHAPES),
                                 "policy": "optimized"}
    tasks = sorted((e for e in spans if e["name"] == "repro.task"),
                   key=lambda e: e["ts"])
    assert [e["args"] for e in tasks] == [
        {"queue": q, "task": a.task_index, "cls": a.cls.value}
        for q in (q0, q1) for a in ms.assignments]
    for e in spans:
        q = queues[0] if e["ts"] < queues[1]["ts"] else queues[1]
        assert q["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                       <= q["ts"] + q["dur"])
    syncs = [e["args"] for e in spans if e["name"] == "repro.sync"]
    assert syncs[0] == {"what": "density", "values": 2 * len(SHAPES)}
    assert {s["what"] for s in syncs[1:]} == {"density", "capacity"}
    converts = [e["args"] for e in spans if e["name"] == "repro.convert"]
    assert all(set(c) == {"shape", "major_axis", "cap"} for c in converts)
    assert {e["args"]["mirror"] for e in spans
            if e["name"].startswith("repro.dispatch.")} == {False, True}


def test_outputs_bit_equal_with_spans_on_and_off():
    """Recording changes no decision and no bit: the same queue with
    spans off, with obs on, and under a profiler with obs on."""
    plain, ms = run("small5_optimized")
    obs.enable()
    try:
        traced, ms_t = run("small5_optimized")
        with profile(activities=[ProfilerActivity.CPU]):
            profiled, ms_p = run("small5_optimized")
    finally:
        obs.disable()
    assert ms_t == ms == ms_p
    for x, y, z in zip(plain, traced, profiled):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_a_span_under_a_profiler_with_obs_on_is_both():
    """A span is a profiler range of its name while a profiler records,
    and also a ring-buffer event with obs on; the range alone with obs
    off."""
    tr = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("repro.alone", cat="queue"):
            pass
        obs.enable()
        try:
            with tr.span("repro.both", cat="queue", k=1):
                pass
        finally:
            obs.disable()
    assert sorted(r[0] for r in program_ranges(prof)) == [
        "repro.alone", "repro.both"]
    (ev,) = tr.events()
    assert ev["name"] == "repro.both" and ev["args"] == {"k": 1}


def test_single_matmul_fetches_its_densities_in_a_sync_span():
    a, b = queue_pairs()[2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, sched = hm.hetero_matmul(a, b, small5(), block=32,
                                      device="cpu")
    names = collections.Counter(r[0] for r in program_ranges(prof))
    parts = [p for p in sched.partitions if not p.region.empty]
    assert names["repro.sync"] == 1 + any(compressed(p) for p in parts)
    assert names["repro.convert"] == sum(len(compressed(p)) for p in parts)
    assert names["repro.merge"] == 1 and "repro.queue" not in names
    assert torch.allclose(out, a @ b, atol=1e-4)


def test_trace_module_imports_no_torch():
    """``obs/trace.py`` stays stdlib-only: loaded alone, with spans
    recorded, it imports no torch."""
    path = Path(trace_mod.__file__)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(path)!r})\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "assert t.TRACE.span('x') is t._NULL_SPAN\n"
        "t.enable()\n"
        "with t.TRACE.span('y', a=1):\n"
        "    pass\n"
        "assert [e['name'] for e in t.TRACE.events()] == ['y']\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
