"""The most device memory any unit of the window took: the caching
allocator's ``max_memory_allocated`` during the unit, less what was
allocated at its hand-over (the operands the harness holds, and the
outputs it keeps for the check), in GiB."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return max(rec.peak_bytes) / 2 ** 30
