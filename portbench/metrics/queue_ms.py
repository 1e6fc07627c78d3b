"""The window (first hand-over to the last unit's synchronised outputs)
over the number of units completed, in milliseconds: the time to a
solution of the tenants' batch."""


def read(rec):
    if not rec.unit_s:
        return None
    return 1e3 * rec.window_s / len(rec.unit_s)
