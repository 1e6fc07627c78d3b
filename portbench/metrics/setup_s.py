"""Set-up: from the start of the process to the hand-over of the
window's first unit (imports, the card, loading or building the kernels,
drawing the operands, counting their work, the warm-up units)."""


def read(rec):
    return rec.setup_s
