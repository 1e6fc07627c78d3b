"""The 95th percentile of every unit's time in the window (hand-over to
synchronised outputs), in milliseconds, interpolated linearly between
the two nearest ranks."""


def read(rec):
    xs = sorted(rec.unit_s)
    if not xs:
        return None
    pos = 0.95 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return 1e3 * (xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
