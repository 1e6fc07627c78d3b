"""Host time issuing the latent attention a unit, in milliseconds, over
the traced window: the port's ``repro.mla.*`` spans (a layer's absorbed
attention and its cache insert in decode, the expanded path in prefill)
where the step is issued op by op, and the ``repro.decode.replay`` span
where it is a captured graph, whose replay issues the latent attention
with the rest of the step; None where the program opens neither."""
from portbench.metrics import _program_spans as ps

PREFIXES = ("repro.mla.", "repro.decode.replay")


def read(rec):
    found = ps.spans(rec)
    if found is None:
        return None
    mine = [iv for name, ivs in found.items() if name.startswith(PREFIXES)
            for iv in ivs]
    if not mine:
        return None
    return ps.total_us(mine) / 1e3 / rec.trace.units
