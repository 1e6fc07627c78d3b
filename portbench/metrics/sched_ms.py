"""Host time in the scheduler (``repro.schedule`` spans: the policy and
its ``OnlineScheduler`` engine), summed over the traced window, per
unit, in milliseconds."""
from portbench.metrics import _program_spans as ps


def read(rec):
    found = ps.spans(rec)
    if found is None:
        return None
    return ps.total_us(found.get("repro.schedule", ())) / 1e3 / rec.trace.units
