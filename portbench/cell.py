"""Run one cell once: set-up, the measured window, the traced window
(``trace=True``), then the check of a seeded sample of the window's
outputs against the plain reference. Returns the result line's object.

The window is a closed loop over whole units (a queue, a decode step):
each is timed on the host clock from its hand-over to its outputs
synchronised, and the window runs until ``seconds`` have passed, so no
unit is cut.
Consecutive units alternate operand sets. A sample of ``check_units``
units, drawn from the seed over every unit of the window (a reservoir),
keeps its outputs for the check; ``judged(outputs, handed, readings)``,
where given, sees that sample as the check judged it."""
from __future__ import annotations

import math
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from portbench import devtrace
from portbench.spec import ROOT, Bench


@dataclass
class Record:
    """What the metric readers read."""

    setup_s: float = 0.0
    unit_s: List[float] = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: List[int] = field(default_factory=list)
    bound_s: float = 0.0        # a unit's bound, averaged over the window
    flops_s: float = 0.0        # its operations at the peak, averaged alike
    trace: Optional[devtrace.Trace] = None
    trace_bound_s: float = 0.0  # a unit's bound, averaged over the trace


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run(cell: str, seed: int, seconds: float, trace: bool,
        device="cuda", root=ROOT, t_start: Optional[float] = None,
        log: Callable[[str], None] = _stderr,
        judged: Optional[Callable] = None) -> Dict:
    from repro_torch.core import costmodel

    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    spec = bench.cell(cell)
    config = bench.config(spec["config"])
    mix = bench.traffic(spec["traffic"])
    accel = (costmodel.config_from_json(config["accelerator"])
             if "accelerator" in config else None)
    reference = bench.reference(config["reference"])
    limits = bench.reference_limits(config["reference"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    traffic = bench.generator(mix["kind"]).Traffic(mix, config, accel, dev)
    n_sets, keep = traffic.n_sets, int(mix["check_units"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    traffic.prepare(gen)
    # Warm-up: every set, and as many units held at once as the window
    # holds (the sample and the unit in flight), so the allocator already
    # has every block the window asks for.
    held = [traffic.run(i % n_sets) for i in range(max(keep + 1, n_sets))]
    sync()
    del held
    rec = Record()
    peak_all = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec.setup_s = time.perf_counter() - t_start
    log(f"portbench {cell}: set-up {rec.setup_s:.3f} s, "
        f"{len(traffic.tasks)} tasks a {traffic.unit}")

    # ---- the measured window
    rng = random.Random(seed)
    sample = []
    i, w0 = 0, time.perf_counter()
    while True:
        s = i % n_sets
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        u0 = time.perf_counter()
        outs = traffic.run(s)
        sync()
        u1 = time.perf_counter()
        rec.unit_s.append(u1 - u0)
        if cuda:
            peak = torch.cuda.max_memory_allocated(dev)
            peak_all = max(peak_all, peak)
            rec.peak_bytes.append(peak - before)
        if i < keep:
            sample.append((i, s, outs))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                sample[j] = (i, s, outs)
        del outs
        i += 1
        if u1 - w0 >= seconds:
            break
    rec.window_s = u1 - w0
    units = i
    rec.bound_s = sum(traffic.bound_s(u % n_sets)
                      for u in range(units)) / units
    rec.flops_s = sum(traffic.flops_s(u % n_sets)
                      for u in range(units)) / units
    ms = sorted(1e3 * x for x in rec.unit_s)
    log(f"portbench {cell}: window {rec.window_s:.3f} s, {units} "
        f"{traffic.unit}s of {ms[0]:.3f} to {ms[-1]:.3f} ms, median "
        f"{ms[len(ms) // 2]:.3f}")

    # ---- the traced window
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        n = int(mix["profile_units"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        sync()
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW_RANGE):
                for j in range(n):
                    with record_function(devtrace.UNIT_RANGE):
                        outs = traffic.run((units + j) % n_sets)
                        sync()
                    del outs
        rec.trace = devtrace.from_profiler(prof, units=n)
        rec.trace_bound_s = sum(traffic.bound_s((units + j) % n_sets)
                                for j in range(n)) / n
        if cuda:
            peak_all = max(peak_all, torch.cuda.max_memory_allocated(dev))
        log(f"portbench {cell}: traced {n} {traffic.unit}s, "
            f"{len(rec.trace.device)} device events")

    # ---- metrics
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check, once the memory peak is read and the program's
    # state is dropped, so only the sample's outputs stay
    traffic.release()
    outputs, handed = [], []
    for _, s, outs in sorted(sample, key=lambda t: t[0]):
        outputs += outs
        handed += traffic.operands(s)
    del sample
    readings, per_task = reference.readings(outputs, handed, dev)
    if judged is not None:      # the calibration's hook
        judged(outputs, handed, readings)
    del outputs

    def sound(k, x):
        return math.isfinite(x) and x <= limits[k]

    correct = all(sound(k, readings[k]) for k in limits)
    failed = sum(not all(sound(k, x) for k, x in t.items()
                         if k in limits) for t in per_task)

    result = {
        "correct": correct,
        "attempted": units * len(traffic.tasks),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if cuda
                     else dev.type),
            "count": int(spec["chips"]),
            "memory_peak_bytes": int(peak_all),
        },
    }
    if rec.trace is not None:
        result["device"]["busy_s"] = devtrace.busy_us(rec.trace) / 1e6
        result["device"]["window_s"] = rec.trace.window_us / 1e6
        result["breakdown"] = {
            "device_ops": devtrace.device_ops(rec.trace),
            "idle_gaps": devtrace.idle_gaps(rec.trace)}
    result["checks"] = {k: {"value": _number(readings[k]), "limit": limit}
                        for k, limit in limits.items()}
    for k, limit in limits.items():
        log(f"check {k} {readings[k]!r} limit {limit!r}")
    return result
