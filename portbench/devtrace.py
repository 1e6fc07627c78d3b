"""Reduce a ``torch.profiler`` trace to what the metric readers read.

Device events are the profiler's CUDA events: kernels, copies and
memsets. The busy time is the union of their intervals (the same rule as
the port's ``chip_smoke.profile_run``, copied here so that the yardstick
does not move with the program). Idle gaps are the stretches of the
traced window in which no device event ran, each named after what the
host was doing at its middle: the innermost profiler range open there."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

#: The profiler range around the traced window, and around each unit of
#: work (a queue or a trace) in it.
WINDOW_RANGE = "portbench.window"
UNIT_RANGE = "portbench.unit"
#: Device events whose name holds this are the port's own CUDA kernels
#: (``namespace rt`` in ``repro_torch/kernels/csrc``).
KERNEL_MARK = "rt::"


@dataclass
class Event:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return max(self.end_us - self.start_us, 0.0)


@dataclass
class Trace:
    """One traced window: device events, host ranges, its bounds on the
    profiler's clock, and the units of work it holds."""

    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0
    units: int = 0

    @property
    def window_us(self) -> float:
        return max(self.end_us - self.start_us, 0.0)


def from_profiler(prof, units: int) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace(units=units)
    for e in prof.events():
        r = e.time_range
        ev = Event(e.name, float(r.start), float(r.end))
        if e.device_type != cuda:
            tr.host.append(ev)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in (WINDOW_RANGE, UNIT_RANGE)):
            # A profiler range shows on the device's timeline too; it is
            # no device work.
            tr.device.append(ev)
    window = [e for e in tr.host if e.name == WINDOW_RANGE]
    if window:
        tr.start_us, tr.end_us = window[0].start_us, window[0].end_us
    elif tr.device:
        tr.start_us = min(e.start_us for e in tr.device)
        tr.end_us = max(e.end_us for e in tr.device)
    return tr


def clipped(events: Sequence[Event], lo: float, hi: float):
    for e in events:
        s, t = max(e.start_us, lo), min(e.end_us, hi)
        if t > s:
            yield s, t


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of the device events' intervals inside the window."""
    out: List[Tuple[float, float]] = []
    for s, t in sorted(clipped(tr.device, tr.start_us, tr.end_us)):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def busy_us(tr: Trace) -> float:
    return sum(t - s for s, t in busy_intervals(tr))


def kernel_us(tr: Trace, port: bool) -> float:
    """Summed device time of the port's kernels (``port``) or of every
    other device event, inside the window."""
    return sum(t - s for e in tr.device if (KERNEL_MARK in e.name) == port
               for s, t in clipped([e], tr.start_us, tr.end_us))


def short_name(name: str) -> str:
    return name.split("(")[0].replace("void ", "")[:80]


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """The device operations that took most time, in seconds."""
    by: Dict[str, float] = {}
    for e in tr.device:
        for s, t in clipped([e], tr.start_us, tr.end_us):
            key = short_name(e.name)
            by[key] = by.get(key, 0.0) + (t - s) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> List[List]:
    """Idle seconds of the window summed by what the host was doing:
    each gap between busy intervals is named after the innermost host
    range open at its middle (the harness's own ranges count as "host
    Python", the program's code between torch calls)."""
    edges = [tr.start_us]
    for s, t in busy_intervals(tr):
        edges += [s, t]
    edges.append(tr.end_us)
    host = sorted(tr.host, key=lambda e: e.start_us)
    by: Dict[str, float] = {}
    # A sweep over the gaps in order: ``live`` holds the host ranges open
    # at the last middle; one that ended before a middle ended before
    # every later one too. The innermost is the shortest open range.
    live: List[Event] = []
    nxt = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt].start_us <= mid:
            live.append(host[nxt])
            nxt += 1
        live = [e for e in live if e.end_us >= mid]
        inner = min(live, key=lambda e: e.dur_us, default=None)
        name = ("host Python" if inner is None
                or inner.name in (WINDOW_RANGE, UNIT_RANGE)
                else short_name(inner.name))
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
