"""The units' bound (``portbench.work``: effectual operations at the
compute peak or dense bytes at HBM's, whichever is longer) over the
card's busy time in the traced window, in percent."""
from portbench import devtrace


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    busy_s = devtrace.busy_us(tr) / 1e6
    if busy_s <= 0:
        return None
    return 100.0 * rec.trace_bound_s * tr.units / busy_s
