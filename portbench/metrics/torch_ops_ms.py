"""Device time of every other kernel, copy and memset (slicing, capacity
reductions, ``dense_to_ell``, the merge, uploads), summed over the traced
window, per unit, in milliseconds."""
from portbench import devtrace


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units or not any(
            devtrace.KERNEL_MARK not in e.name for e in tr.device):
        return None
    return devtrace.kernel_us(tr, port=False) / 1e3 / tr.units
