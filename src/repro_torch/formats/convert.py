"""Format converters — the software analogue of AESPA's hardware
(de)compressors and on-the-fly format-conversion blocks (paper §IV-C);
the port of ``repro.formats.convert`` on tensors.

Conversion *cost* (bytes moved) is reported alongside so a caller can
charge converter traffic as the paper does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.formats.ell import EllMatrix, dense_to_ell, ell_to_dense
from repro_torch.formats.taxonomy import MatrixCCF


def major_axis_for(ccf: MatrixCCF, operand: str) -> int:
    """Fiber axis of the logical matrix for a CCF descriptor.

    ``operand`` is "A" (logical M×K) or "B" (logical K×N).
    """
    if operand == "A":
        return 0 if ccf.outer == "M" else 1
    if operand == "B":
        return 0 if ccf.outer == "K" else 1
    raise ValueError(operand)


def to_format(dense: torch.Tensor, ccf: MatrixCCF, operand: str, cap: int,
              strict: bool = False):
    """Dense -> (dense | EllMatrix) per CCF. The 'decompressor bypass'.

    ``strict`` raises instead of silently truncating fibers that exceed
    ``cap`` (see :func:`repro_torch.formats.ell.dense_to_ell`)."""
    if ccf.is_dense:
        return dense
    return dense_to_ell(dense, major_axis_for(ccf, operand), cap,
                        strict=strict)


def to_dense(x) -> torch.Tensor:
    return ell_to_dense(x) if isinstance(x, EllMatrix) else x


def convert(x, src: MatrixCCF, dst: MatrixCCF, operand: str, cap: int,
            strict: bool = False):
    """Arbitrary CCF -> CCF conversion (via dense staging, like the paper's
    converter block which re-streams (meta)data through a small buffer)."""
    if str(src) == str(dst):
        return x
    return to_format(to_dense(x), dst, operand, cap, strict=strict)


def conversion_bytes(shape: Tuple[int, int], density: float, src: MatrixCCF,
                     dst: MatrixCCF, itemsize: int = 4) -> float:
    """Bytes read+written by a converter block (cost-model hook).

    Compressed streams move ``nnz`` values + ``nnz`` coordinates (+ fiber
    pointers); dense streams move the full matrix.
    """
    m, n = shape
    nnz = density * m * n

    def stream(ccf: MatrixCCF) -> float:
        if ccf.is_dense:
            return m * n * itemsize
        return nnz * (itemsize + 4) + max(m, n) * 4

    if str(src) == str(dst):
        return 0.0
    return stream(src) + stream(dst)
