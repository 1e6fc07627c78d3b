"""The share of the traced window in which no kernel, copy or memset ran
on the card, in percent."""
from portbench import devtrace


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_us(tr) / tr.window_us)
