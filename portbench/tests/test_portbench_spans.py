"""The readers of the program's own spans (``sched_ms``, ``sync_ms``,
``host_syncs``, ``host_exec_ms`` and their ``.small`` twins) on a canned
trace, without program spans, through ``devtrace.from_profiler``, and in
a traced run of a cell on the CPU."""
from __future__ import annotations

import types

import pytest
import torch

from portbench import cell, devtrace
from portbench.cell import Record
from portbench.devtrace import Event, Trace
from portbench.spec import ROOT, Bench

BENCH = Bench(ROOT)
READERS = ("sched_ms", "sync_ms", "host_syncs", "host_exec_ms")


def canned_trace() -> Trace:
    """A 1000 us window over 2 queues. Queue 1 (0-400): a density sync
    10-30, the schedule 40-100, a task 110-300 holding a conversion, a
    capacity sync 150-190, a dispatch and the merge. Queue 2 (500-950):
    syncs 510-520 and 600-700, the schedule 530-560, a task 570-900.
    Outside both: a sync 960-980, and a schedule 990-1020 that the
    window cuts to 990-1000."""
    host = [Event(devtrace.WINDOW_RANGE, 0, 1000),
            Event(devtrace.UNIT_RANGE, 0, 450),
            Event(devtrace.UNIT_RANGE, 450, 1000),
            Event("repro.queue", 0, 400),
            Event("repro.sync", 10, 30),
            Event("repro.schedule", 40, 100),
            Event("repro.task", 110, 300),
            Event("repro.convert", 120, 140),
            Event("repro.sync", 150, 190),
            Event("repro.dispatch.spmm", 200, 250),
            Event("aten::mm", 205, 245),
            Event("repro.merge", 260, 290),
            Event("repro.queue", 500, 950),
            Event("repro.sync", 510, 520),
            Event("repro.schedule", 530, 560),
            Event("repro.task", 570, 900),
            Event("repro.sync", 600, 700),
            Event("repro.sync", 960, 980),
            Event("repro.schedule", 990, 1020)]
    dev = [Event("void rt::gemm_kernel<1>(float const*)", 200, 260)]
    return Trace(device=dev, host=host, start_us=0, end_us=1000, units=2)


def read(name, rec):
    return BENCH.reader(name)(rec)


def test_span_readers_by_hand():
    rec = Record(trace=canned_trace())
    # 60 + 30 + 10 (cut) us over 2 queues.
    assert read("sched_ms", rec) == pytest.approx(0.100 / 2)
    # 20 + 40 + 10 + 100 + 20 us, five syncs.
    assert read("sync_ms", rec) == pytest.approx(0.190 / 2)
    assert read("host_syncs", rec) == pytest.approx(2.5)
    # Queues 400 + 450 us, less their schedules (60 + 30) and their
    # syncs (20 + 40 + 10 + 100): the sync and schedule outside them
    # are no queue's.
    assert read("host_exec_ms", rec) == pytest.approx(0.590 / 2)
    for name in READERS:
        assert read(f"{name}.small", rec) == read(name, rec)


def test_span_readers_sum_to_the_queue_when_all_lies_inside():
    """With every schedule and sync inside a queue, the three times add
    up to the mean ``repro.queue`` span."""
    tr = canned_trace()
    tr.host = [e for e in tr.host if e.start_us < 950]
    rec = Record(trace=tr)
    total = sum(read(n, rec) for n in ("sched_ms", "sync_ms",
                                       "host_exec_ms"))
    assert total == pytest.approx((400 + 450) / 1e3 / 2)


def test_span_readers_return_nothing_without_program_spans():
    harness_only = Trace(
        device=[Event("void rt::gemm_kernel<1>()", 0, 5)],
        host=[Event(devtrace.WINDOW_RANGE, 0, 10),
              Event(devtrace.UNIT_RANGE, 0, 10), Event("aten::mm", 1, 4)],
        start_us=0, end_us=10, units=1)
    outside = canned_trace()
    outside.start_us, outside.end_us = 2000, 3000
    for rec in (Record(), Record(trace=harness_only),
                Record(trace=Trace(host=canned_trace().host, units=0)),
                Record(trace=outside)):
        for name in READERS:
            assert read(name, rec) is None, name
            assert read(f"{name}.small", rec) is None, name
    # A trace with program spans but none of one kind reads zero.
    no_sync = canned_trace()
    no_sync.host = [e for e in no_sync.host if e.name != "repro.sync"]
    assert read("host_syncs", Record(trace=no_sync)) == 0.0
    assert read("sync_ms", Record(trace=no_sync)) == 0.0


def test_from_profiler_keeps_program_ranges_off_the_device():
    """A program range opened as a user annotation shows on the device's
    timeline too; it stays off it, and on the host, as does one opened
    as a plain host op (the tracer's fast range)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, t, dev, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=s, end=t))

    events = [ev(devtrace.WINDOW_RANGE, 0, 100, cpu),
              ev(devtrace.UNIT_RANGE, 0, 100, cpu)]
    for name, s, t in (("repro.queue", 1, 99), ("repro.task", 20, 80),
                       ("repro.dispatch.gemm", 30, 60),
                       ("repro.sync", 85, 95)):
        events += [ev(name, s, t, cpu, annotation=True),
                   ev(name, s + 2, t + 2, cuda, annotation=True)]
    events += [ev("repro.merge", 62, 70, cpu),
               ev("void rt::gemm_kernel<float, true>()", 40, 55, cuda),
               ev("aten::mm", 32, 58, cpu)]
    tr = devtrace.from_profiler(types.SimpleNamespace(events=lambda: events),
                                units=1)
    assert [e.name for e in tr.device] == [
        "void rt::gemm_kernel<float, true>()"]
    assert sorted(e.name for e in tr.host if e.name.startswith("repro.")) \
        == ["repro.dispatch.gemm", "repro.merge", "repro.queue",
            "repro.sync", "repro.task"]
    rec = Record(trace=tr)
    assert read("host_syncs", rec) == 1.0
    assert read("sync_ms", rec) == pytest.approx(0.010)
    assert read("host_exec_ms", rec) == pytest.approx(0.088)
    # The gaps around the kernel name the innermost program span.
    gaps = dict(devtrace.idle_gaps(tr))
    assert set(gaps) <= {"repro.task", "repro.dispatch.gemm", "aten::mm",
                         "repro.queue", "repro.sync", "repro.merge"}
    assert "host Python" not in gaps


def test_a_traced_cpu_run_reads_the_spans(small_root):
    """The small cell traced on the CPU: the four ``.small`` readers
    report, ``host_syncs.small`` is one density fetch plus one capacity
    fetch per task with a compressed operand, counted from the schedule
    of the same queue, and nothing reads the plain names there."""
    from repro_torch.core import costmodel
    from repro_torch.core.hetero_matmul import (_compressed_operands,
                                                hetero_many_matmul)

    name = "aespa_equal4.small_lpt"
    result = cell.run(name, 2 ** 31 + 11, 0.05, True, device="cpu",
                      root=small_root, log=lambda msg: None)
    assert result["correct"]
    got = result["metrics"]
    assert {f"{n}.small" for n in READERS} <= set(got)
    assert not set(READERS) & set(got)

    bench = Bench(small_root)
    spec = bench.cell(name)
    config = bench.config(spec["config"])
    mix = bench.traffic(spec["traffic"])
    accel = costmodel.config_from_json(config["accelerator"])
    traffic = bench.generator(mix["kind"]).Traffic(mix, config, accel,
                                                   "cpu")
    traffic.prepare(torch.Generator().manual_seed(3))
    _, ms = hetero_many_matmul(traffic.sets[0], accel,
                               policy=mix["policy"],
                               block=int(config["block"]), device="cpu")
    synced = sum(any(_compressed_operands(pp.partition.cls,
                                          pp.partition.mirror)
                     for pp in a.placed if not pp.partition.region.empty)
                 for a in ms.assignments)
    assert got["host_syncs.small"]["value"] == 1 + synced
    assert 0 < synced < len(ms.assignments)
    for n in ("sched_ms", "sync_ms", "host_exec_ms"):
        assert got[f"{n}.small"]["value"] > 0
