"""Operands drawn from the seed: standard normal values under a uniform
mask that holds exactly ``round(density * size)`` nonzeros, so every seed
gives every task the same nonzero count (and so the same densities, the
same schedule and the same work) and only the values and their places
change. Drawn on the device in a few large calls."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def nonzeros(rows: int, cols: int, density: float) -> int:
    """The exact nonzero count of a ``rows x cols`` matrix at
    ``density``."""
    return min(rows * cols, max(0, round(density * rows * cols)))


def draw(rows: int, cols: int, density: float, gen: torch.Generator,
         dtype: torch.dtype) -> torch.Tensor:
    """One ``rows x cols`` matrix on ``gen``'s device."""
    dev = gen.device
    size = rows * cols
    nnz = nonzeros(rows, cols, density)
    if nnz == size:
        return torch.randn((rows, cols), generator=gen, device=dev,
                           dtype=dtype)
    out = torch.zeros(size, device=dev, dtype=dtype)
    if nnz:
        keys = torch.rand(size, generator=gen, device=dev)
        where = torch.topk(keys, nnz, sorted=False).indices
        del keys
        out[where] = torch.randn(nnz, generator=gen, device=dev,
                                 dtype=dtype)
    return out.view(rows, cols)


def draw_pairs(tasks: Sequence, gen: torch.Generator,
               dtype: torch.dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(a, b)`` for each task (anything with ``m, k, n, d_mk, d_kn``),
    in task order."""
    return [(draw(t.m, t.k, t.d_mk, gen, dtype),
             draw(t.k, t.n, t.d_kn, gen, dtype)) for t in tasks]
