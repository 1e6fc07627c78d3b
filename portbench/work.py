"""The work of a task and the least time the card could take for it.

A task's operations are twice its effectual MACs, counted exactly from
the operands handed in: the sum over k of nnz(A[:, k]) * nnz(B[k, :]).
Its bytes are the dense inputs read once and the output written once.
Both count the work the data needs, whatever body or library computes
the product, so a roofline share stays a share of the same work after a
kernel is swapped out.

Peaks: one NVIDIA H100 SXM, dense, from NVIDIA's data sheet. Float32
inputs are taken at the TF32 tensor-core rate, the highest at which the
card accepts float32 operands (a float32-accurate product built from
tensor-core passes would read over 100% against the 67 TFLOP/s of the
CUDA cores)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

#: Dense operations a second at which the card takes each input dtype.
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
#: HBM3 bytes a second.
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Work:
    """The work of one task."""

    macs: int       # effectual multiply-adds
    nbytes: int     # dense inputs read once, output written once
    dtype: torch.dtype

    @property
    def flops(self) -> int:
        return 2 * self.macs


def effectual_macs(a: torch.Tensor, b: torch.Tensor) -> int:
    """Sum over k of nnz(A[:, k]) * nnz(B[k, :]): the products whose both
    factors are nonzero."""
    col = (a != 0).sum(dim=0, dtype=torch.int64)
    row = (b != 0).sum(dim=1, dtype=torch.int64)
    return int((col * row).sum())


def task_work(a: torch.Tensor, b: torch.Tensor) -> Work:
    (m, k), n = a.shape, b.shape[1]
    size = a.element_size()
    return Work(effectual_macs(a, b), size * (m * k + k * n + m * n),
                a.dtype)


def bound_s(works: Sequence[Work]) -> float:
    """The least seconds the card could take for the tasks together: the
    larger of all operations at the compute peak and all bytes at the
    memory peak."""
    ops = sum(w.flops / PEAK_FLOPS[w.dtype] for w in works)
    data = sum(w.nbytes for w in works) / PEAK_BYTES
    return max(ops, data)
