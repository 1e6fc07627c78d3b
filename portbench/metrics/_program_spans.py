"""The port's own spans in a traced window: the ``repro.*`` ranges that
its tracer opens on the profiler's clock while the window is profiled,
read from the window's host events. The readers of the queue's host
layers (scheduling, host syncs, the executor's host time) stand on it."""
from portbench import devtrace

#: The names of the program's spans start with this.
PREFIX = "repro."


def spans(rec):
    """``{name: [(start_us, end_us), ...]}`` of the program's spans,
    clipped to the traced window; None when the trace holds none."""
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    out = {}
    for e in tr.host:
        if e.name.startswith(PREFIX):
            out.setdefault(e.name, []).extend(
                devtrace.clipped([e], tr.start_us, tr.end_us))
    return out if any(out.values()) else None


def total_us(intervals) -> float:
    return sum(t - s for s, t in intervals)


def inside(intervals, outer):
    """The intervals that lie within one of ``outer``."""
    return [(s, t) for s, t in intervals
            if any(a <= s and t <= b for a, b in outer)]
