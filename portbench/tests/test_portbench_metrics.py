"""Each metric reader on a canned record, and the trace reduction it
stands on."""
from __future__ import annotations

import pytest

from portbench import devtrace
from portbench.cell import Record
from portbench.devtrace import Event, Trace
from portbench.spec import ROOT, Bench

BENCH = Bench(ROOT)


def canned_trace() -> Trace:
    """A 100 us window over 2 units: a port kernel 10-30, a copy 20-40
    (overlapping it), another port kernel 60-70, a memset 95-120 (cut at
    the window's end); idle 0-10, 40-60, 70-95; the host in a sync at
    50, in Python elsewhere."""
    dev = [Event("void rt::row_walk_kernel<float>(int)", 10, 30),
           Event("Memcpy HtoD (Pageable -> Device)", 20, 40),
           Event("void rt::gemm_kernel<1>(float const*)", 60, 70),
           Event("Memset (Device)", 95, 120)]
    host = [Event(devtrace.WINDOW_RANGE, 0, 100),
            Event(devtrace.UNIT_RANGE, 0, 58),
            Event(devtrace.UNIT_RANGE, 58, 100),
            Event("aten::nonzero", 45, 58),
            Event("cudaStreamSynchronize", 47, 55)]
    return Trace(device=dev, host=host, start_us=0, end_us=100, units=2)


def record(**kw) -> Record:
    rec = Record(setup_s=12.5,
                 unit_s=[0.060, 0.070, 0.065, 0.080, 0.061],
                 window_s=0.336, peak_bytes=[3 << 30, 4 << 30, 2 << 30],
                 bound_s=0.0008, flops_s=0.0002, trace=canned_trace(),
                 trace_bound_s=0.00001)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def read(name, rec):
    return BENCH.reader(name)(rec)


def test_busy_union_and_split():
    tr = canned_trace()
    assert devtrace.busy_intervals(tr) == [(10, 40), (60, 70), (95, 100)]
    assert devtrace.busy_us(tr) == 45
    assert devtrace.kernel_us(tr, port=True) == 30
    assert devtrace.kernel_us(tr, port=False) == 25


def test_breakdown_names_and_gaps():
    tr = canned_trace()
    ops = dict(devtrace.device_ops(tr))
    assert ops == pytest.approx({"rt::row_walk_kernel<float>": 20e-6,
                                 "Memcpy HtoD ": 20e-6,
                                 "rt::gemm_kernel<1>": 10e-6,
                                 "Memset ": 5e-6})
    gaps = dict(devtrace.idle_gaps(tr))
    # 0-10 and 70-95 in Python; 40-60 (middle 50) inside the sync.
    assert gaps == pytest.approx({"host Python": 35e-6,
                                  "cudaStreamSynchronize": 20e-6})


def test_end_to_end_readers():
    rec = record()
    assert read("setup_s", rec) == 12.5
    assert read("queue_ms", rec) == pytest.approx(336 / 5)
    # 0.95 * 4 = 3.8: between 70 and 80 ms.
    assert read("queue_p95_ms", rec) == pytest.approx(78.0)
    assert read("peak_mem_gib", rec) == 4.0


def test_per_layer_readers():
    rec = record()
    assert read("kernel_ms", rec) == pytest.approx(0.030 / 2)
    assert read("torch_ops_ms", rec) == pytest.approx(0.025 / 2)
    assert read("device_idle_pct", rec) == pytest.approx(55.0)
    assert read("device_roofline_pct", rec) == pytest.approx(
        100 * 0.00001 * 2 / 45e-6)
    assert read("queue_roofline_pct", rec) == pytest.approx(
        100 * 0.0008 / 0.0672)


def test_decode_readers():
    """The model cell's metrics read the record as the queue's do, a step
    being a unit; ``mfu`` reads the operations alone at the peak."""
    rec = record()
    assert read("queue_ms.decode", rec) == pytest.approx(336 / 5)
    assert read("queue_roofline_pct.decode", rec) == pytest.approx(
        100 * 0.0008 / 0.0672)
    assert read("mfu.decode", rec) == pytest.approx(100 * 0.0002 / 0.0672)
    assert read("mfu.decode", record(trace=None)) is None
    assert read("mfu.decode", record(flops_s=0.0)) is None
    assert read("device_idle_pct.decode", rec) == pytest.approx(55.0)
    assert read("device_roofline_pct.decode", rec) == pytest.approx(
        100 * 0.00001 * 2 / 45e-6)


def test_readers_return_nothing_without_data():
    empty = record(unit_s=[], peak_bytes=[], trace=None)
    for m in BENCH.spec["end_to_end"] + BENCH.spec["per_layer"]:
        if m["name"] != "setup_s":
            assert read(m["name"], empty) is None, m["name"]
    no_device = record(trace=Trace(host=[], start_us=0, end_us=10, units=1))
    for name in ("kernel_ms", "torch_ops_ms", "device_idle_pct",
                 "device_roofline_pct"):
        assert read(name, no_device) is None
    no_port = record(trace=Trace(device=[Event("Memset", 0, 5)],
                                 start_us=0, end_us=10, units=1))
    assert read("kernel_ms", no_port) is None
    assert read("torch_ops_ms", no_port) == pytest.approx(0.005)


def test_from_profiler_leaves_profiler_ranges_off_the_device():
    """A profiler range shows on the device's timeline too (a user
    annotation); it is no device work."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, t, dev, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=s, end=t))

    prof = types.SimpleNamespace(events=lambda: [
        ev(devtrace.WINDOW_RANGE, 0, 100, cpu),
        ev(devtrace.UNIT_RANGE, 0, 100, cpu),
        ev(devtrace.UNIT_RANGE, 0, 100, cuda, annotation=True),
        ev("some_range", 5, 90, cuda, annotation=True),
        ev("void rt::gemm_kernel<float, true>()", 10, 20, cuda),
        ev("aten::mm", 8, 12, cpu)])
    tr = devtrace.from_profiler(prof, units=1)
    assert [e.name for e in tr.device] == [
        "void rt::gemm_kernel<float, true>()"]
    assert (tr.start_us, tr.end_us, tr.window_us) == (0, 100, 100)
    assert devtrace.busy_us(tr) == 10
    assert len(tr.host) == 3
