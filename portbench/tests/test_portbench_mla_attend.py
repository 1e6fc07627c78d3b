"""The absorbed-attention kernel's roofline share
(``metrics/mla_attend_roofline_pct.py``) on canned traces, and on a CPU
profile of the port's captured step, whose counters it reads."""
from __future__ import annotations

import pytest
import torch

from portbench.cell import Record
from portbench.devtrace import UNIT_RANGE, WINDOW_RANGE, Event, Trace
from portbench.spec import ROOT, Bench
from portbench.work import PEAK_BYTES

BENCH = Bench(ROOT)
READ = BENCH.reader("mla_attend_roofline_pct.decode")


def canned(device, host):
    return Trace(device=device,
                 host=[Event(WINDOW_RANGE, 0, 1000),
                       Event(UNIT_RANGE, 0, 500), Event(UNIT_RANGE, 500, 1000),
                       *host], start_us=0, end_us=1000, units=2)


def test_the_share_reads_the_counters_and_the_kernels_time():
    """Two steps of 27 launches over 1000 and 3000 keys a layer: their
    bytes (1152 a key and layer) at the peak over the split and merge
    kernels' time in the window; other kernels and marks outside the
    window are not read."""
    device = [Event("void rt::mla_attend_split_kernel<2>(rt::MlaArgs)", 10,
                    70),
              Event("rt::mla_attend_merge_kernel(rt::MlaArgs)", 70, 80),
              Event("void rt::mla_attend_split_kernel<2>(rt::MlaArgs)", 510,
                    600),
              Event("rt::mla_attend_merge_kernel(rt::MlaArgs)", 990, 1010),
              Event("nvjet_gemm", 100, 400)]
    host = [Event("counter:repro.mla.positions=1000.0", 1, 1),
            Event("counter:repro.mla.attend_launches=27.0", 2, 2),
            Event("counter:repro.mla.positions=3000.0", 501, 501),
            Event("counter:repro.mla.attend_launches=27.0", 502, 502),
            Event("counter:repro.mla.positions=9.0", 1200, 1200),
            Event("repro.decode.replay", 3, 60)]
    got = READ(Record(trace=canned(device, host)))
    want_s = 1152 * 27 * 4000 / PEAK_BYTES
    assert got == pytest.approx(100 * want_s / 170e-6)


@pytest.mark.parametrize("device,host", [
    ([Event("nvjet_gemm", 0, 5)],
     [Event("counter:repro.mla.positions=1000.0", 1, 1)]),
    ([Event("void rt::mla_attend_split_kernel<2>(rt::MlaArgs)", 10, 70)],
     []),
    ([Event("void rt::mla_attend_split_kernel<2>(rt::MlaArgs)", 10, 70)],
     [Event("counter:repro.mla.positions=1000.0", 1, 1)]),
])
def test_nothing_to_read_gives_none(device, host):
    """No launch of the kernel (a program without it), no marks, or a
    step's keys without its launch count."""
    assert READ(Record(trace=canned(device, host))) is None
    assert READ(Record()) is None


def test_a_cpu_profile_of_the_captured_step_carries_the_marks():
    """The port's step through ``make_decode_step(graph=True)`` under a CPU
    profiler leaves the two counters' marks where the reader finds them;
    with no kernel on the CPU it reads None."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace
    from repro_torch.configs import get_reduced
    from repro_torch.models import build
    from repro_torch.serve import engine

    m = build(get_reduced("deepseek-v2-lite"))
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    step = engine.make_decode_step(m, graph=True)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with torch.inference_mode():
        cache = m.init_cache(2, 16, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(WINDOW_RANGE):
                step(p, cache, tok, torch.tensor([3, 8], dtype=torch.int32))
    tr = devtrace.from_profiler(prof, units=1)
    names = [e.name for e in tr.host if e.name.startswith("counter:")]
    assert names == ["counter:repro.mla.positions=13.0",
                     "counter:repro.mla.attend_launches=0.0"]
    assert READ(Record(trace=tr)) is None
