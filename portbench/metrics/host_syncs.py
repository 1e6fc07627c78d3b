"""The number of the program's host fetches (``repro.sync`` spans) in
the traced window, per unit."""
from portbench.metrics import _program_spans as ps


def read(rec):
    found = ps.spans(rec)
    if found is None:
        return None
    return len(found.get("repro.sync", ())) / rec.trace.units
