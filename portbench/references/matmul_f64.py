"""The plain reference of a matmul queue: each product in float64 with
plain torch, from the dense operands the program was handed, and the
control that has to fail its limit.

It imports nothing of the port and takes nothing the port made: it reads
the program's outputs only to judge them. The number compared is the
worst normwise relative error over the checked tasks,
``max |out - A @ B| / max |A @ B|`` in float64, so one wrong, missing or
doubled product anywhere in a task shows at its own size."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

#: Rows of A a reference block holds.
BLOCK_ROWS = 4096


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def task_error(out, a, b, device) -> float:
    """Normwise relative error of ``out`` against the float64 product;
    infinite for a missing, misshapen or non-finite output."""
    m, n = a.shape[0], b.shape[1]
    if out is None or tuple(out.shape) != (m, n):
        return math.inf
    b64 = _on(b, device).double()
    err = ref = 0.0
    for r0 in range(0, m, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, m)
        want = _on(a[r0:r1], device).double() @ b64
        got = _on(out[r0:r1], device).double()
        if not bool(torch.isfinite(got).all()):
            return math.inf
        err = max(err, float((got - want).abs().max()) if want.numel() else 0.0)
        ref = max(ref, float(want.abs().max()) if want.numel() else 0.0)
    if ref == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / ref


def readings(outputs: Sequence, operands: Sequence[Tuple], device
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """The numbers compared, over every output with its operands, and
    each task's own."""
    per_task = [{"max_rel_err": task_error(out, a, b, device)}
                for out, (a, b) in zip(outputs, operands, strict=True)]
    worst = max((t["max_rel_err"] for t in per_task), default=0.0)
    return {"max_rel_err": worst}, per_task


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def control(a, b, device) -> torch.Tensor:
    """The reference in the program's place one precision below the
    configuration's float32: both inputs rounded to TF32, as the tensor
    cores take them, products accumulated in float32 (TF32 off)."""
    aa, bb = to_tf32(_on(a, device)), to_tf32(_on(b, device))
    prev = (torch.backends.cuda.matmul.allow_tf32
            if aa.is_cuda else None)
    if aa.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return aa @ bb
    finally:
        if aa.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = prev
