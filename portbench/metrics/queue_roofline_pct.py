"""A unit's bound over its mean time in the measured window of the traced
run (outside the profiled stretch), in percent: the whole entry, host
work included, against the least time the card could take."""


def read(rec):
    if rec.trace is None or not rec.unit_s or rec.bound_s <= 0:
        return None
    return 100.0 * rec.bound_s / (sum(rec.unit_s) / len(rec.unit_s))
