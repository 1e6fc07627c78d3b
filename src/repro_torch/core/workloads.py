"""The paper's diverse workload suite (Table I) + helpers to synthesise
matching random operands for numerical runs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """One matmul kernel: A (M×K, density d_mk) × B (K×N, density d_kn)."""

    name: str
    application: str
    m: int
    k: int
    n: int
    d_mk: float            # fraction in [0, 1]
    d_kn: float

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.m, self.k, self.n)

    @property
    def effectual_macs(self) -> float:
        """Expected useful MACs under uniform random sparsity (paper §VI)."""
        return self.m * self.k * self.n * self.d_mk * self.d_kn

    @property
    def dense_macs(self) -> float:
        return float(self.m) * self.k * self.n


# Table I (densities are % in the paper; stored as fractions).
TABLE_I: List[Workload] = [
    Workload("chem97ZtZ", "stat problem", 2_500, 2_500, 1_200, 0.0011, 1.0),
    Workload("journals", "weighted graph", 124, 124, 62, 0.785, 1.0),
    Workload("m3plates", "acoustics", 11_000, 11_000, 5_500, 0.000054, 1.0),
    Workload("synthetic_dense", "varies", 5_000, 5_000, 2_500, 1.0, 1.0),
    Workload("bibd_81_3", "combinatorial", 3_200, 85_000, 43_000, 0.00093, 1.0),
    Workload("speech", "deep learning", 7_700, 2_600, 1_300, 0.05, 1.0),
    Workload("gnmt", "deep learning", 1_600, 1_000, 36_000, 0.50, 0.30),
    Workload("transformer", "deep learning", 32_000, 84, 1_000, 0.50, 0.30),
    Workload("citeseer", "GNN", 3_300, 3_300, 3_700, 0.0011, 0.0085),
]

BY_NAME = {w.name: w for w in TABLE_I}


def synthesize(w: Workload, seed: int = 0, max_elems: int = 1 << 22):
    """Random operands matching ``w``'s shape/density, scaled down if the
    full size exceeds ``max_elems`` per matrix (numerics only; the cost
    model always uses the true dimensions)."""
    scale = 1.0
    for mat_elems in (w.m * w.k, w.k * w.n):
        if mat_elems * scale * scale > max_elems:
            scale = min(scale, (max_elems / mat_elems) ** 0.5)
    m, k, n = (max(8, int(d * scale)) for d in (w.m, w.k, w.n))
    rng = np.random.default_rng(seed)

    def mat(r, c, density):
        d = rng.standard_normal((r, c)).astype(np.float32)
        return d * (rng.random((r, c)) < density)

    return mat(m, k, w.d_mk), mat(k, n, w.d_kn), (m, k, n)
