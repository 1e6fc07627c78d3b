"""Host time blocked in the program's host fetches (``repro.sync`` spans:
the density and capacity fetches, each waiting for the device to drain
the work before it), summed over the traced window, per unit, in
milliseconds."""
from portbench.metrics import _program_spans as ps


def read(rec):
    found = ps.spans(rec)
    if found is None:
        return None
    return ps.total_us(found.get("repro.sync", ())) / 1e3 / rec.trace.units
