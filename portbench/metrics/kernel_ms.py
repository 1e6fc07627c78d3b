"""Device time of the port's own CUDA kernels (``rt::`` in the profiler's
name), summed over the traced window, per unit, in milliseconds."""
from portbench import devtrace


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units or not any(
            devtrace.KERNEL_MARK in e.name for e in tr.device):
        return None
    return devtrace.kernel_us(tr, port=True) / 1e3 / tr.units
