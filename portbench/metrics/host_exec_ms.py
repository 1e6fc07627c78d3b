"""Host time issuing a queue's work: each ``repro.queue`` span less the
``repro.schedule`` and ``repro.sync`` spans inside it (what is left is
density counts, slicing, conversions, launches and merges), summed over
the traced window, per unit, in milliseconds."""
from portbench.metrics import _program_spans as ps


def read(rec):
    found = ps.spans(rec)
    if found is None:
        return None
    queues = found.get("repro.queue", [])
    held = [iv for name in ("repro.schedule", "repro.sync")
            for iv in ps.inside(found.get(name, ()), queues)]
    return (ps.total_us(queues) - ps.total_us(held)) / 1e3 / rec.trace.units
