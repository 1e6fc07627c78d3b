"""Model FLOPs utilisation of a unit: its operations at the dense peak
of the served dtype (``Record.flops_s``: for a model's step, twice the
weights each token multiplies through plus attention,
``portbench.lm_work``) over its mean time in the measured window of the
traced run, in percent; host work included. Where the unit is bound by
its bytes, as a decode step is, this stays far below the roofline share
(``queue_roofline_pct``) and says how much of the card's arithmetic the
step leaves unused."""


def read(rec):
    if rec.trace is None or not rec.unit_s or rec.flops_s <= 0:
        return None
    return 100.0 * rec.flops_s / (sum(rec.unit_s) / len(rec.unit_s))
