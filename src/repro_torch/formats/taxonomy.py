"""CCF (compute compression format) taxonomy from the paper (Section II).

A matrix format is written ``U_x C_y`` / ``U_x U_y``: the *outer* (major) mode
``x`` is always uncompressed ('U'); the *inner* (minor) mode ``y`` is either
uncompressed ('U', dense) or compressed ('C', only nonzeros stored with
coordinates). Following the paper's M×K×N convention (A: M×K, B: K×N), the
five dataflow classes are keyed by the ``(format(A), format(B))`` pair.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Dim(str, enum.Enum):
    M = "M"
    K = "K"
    N = "N"


@dataclasses.dataclass(frozen=True)
class MatrixCCF:
    """``U_{outer} U/C_{inner}`` for one operand.

    ``outer``/``inner`` are dimension names of the *logical* matrix
    (A: (M, K); B: (K, N)); ``inner_compressed`` says whether the inner mode
    stores only nonzeros (with coordinate metadata).
    """

    outer: str
    inner: str
    inner_compressed: bool

    def __str__(self) -> str:
        tag = "C" if self.inner_compressed else "U"
        return f"U_{self.outer}{tag}_{self.inner}"

    @property
    def is_dense(self) -> bool:
        return not self.inner_compressed


# --- Canonical operand formats (paper Fig 2 / Fig 3) ---------------------
# Matrix A is M×K.
A_UMUK = MatrixCCF("M", "K", False)   # dense, row-major
A_UMCK = MatrixCCF("M", "K", True)    # CSR-like
A_UKCM = MatrixCCF("K", "M", True)    # CSC-like (K-major)
A_UKUM = MatrixCCF("K", "M", False)   # dense, col-major
# Matrix B is K×N.
B_UKUN = MatrixCCF("K", "N", False)   # dense, row-major (K-major)
B_UNCK = MatrixCCF("N", "K", True)    # CSC-like (per output column)
B_UKCN = MatrixCCF("K", "N", True)    # CSR-like (K-major)


class DataflowClass(str, enum.Enum):
    """The five sub-accelerator classes of the paper (Fig 1 / Fig 3)."""

    GEMM = "gemm"                    # TPU-like       (U_M U_K, U_K U_N)
    SPMM = "spmm"                    # EIE-like       (U_M U_K, U_N C_K) | (U_M C_K, U_K U_N)
    SPGEMM_INNER = "spgemm_inner"    # ExTensor-like  (U_M C_K, U_N C_K)
    SPGEMM_OUTER = "spgemm_outer"    # OuterSPACE-like(U_K C_M, U_K C_N)
    SPGEMM_GUSTAVSON = "spgemm_gustavson"  # MatRaptor-like (U_K C_M, U_N C_K)


#: Parallelism dimension bound per class (paper Fig 1, rightmost column).
PARALLELISM_BOUND = {
    DataflowClass.GEMM: ("M", "N"),              # M*N PEs usable
    DataflowClass.SPMM: ("N",),                  # N (or M for mirrored SpMM)
    DataflowClass.SPGEMM_INNER: ("N",),          # M or N; we unroll N
    DataflowClass.SPGEMM_OUTER: ("K",),          # K (paper unrolls K spatially)
    DataflowClass.SPGEMM_GUSTAVSON: ("N",),      # N
}


def classify(fa: MatrixCCF, fb: MatrixCCF) -> DataflowClass:
    """Map a ``(format(A), format(B))`` pair to its dataflow class."""
    pair = (str(fa), str(fb))
    table = {
        (str(A_UMUK), str(B_UKUN)): DataflowClass.GEMM,
        (str(A_UMUK), str(B_UNCK)): DataflowClass.SPMM,
        (str(A_UMCK), str(B_UKUN)): DataflowClass.SPMM,
        (str(A_UMCK), str(B_UNCK)): DataflowClass.SPGEMM_INNER,
        (str(A_UKCM), str(B_UKCN)): DataflowClass.SPGEMM_OUTER,
        (str(A_UKCM), str(B_UNCK)): DataflowClass.SPGEMM_GUSTAVSON,
    }
    try:
        return table[pair]
    except KeyError as e:
        raise ValueError(f"unsupported CCF combination ({fa}, {fb})") from e


#: CCF pair required by each class, in (A, B) order — what the format
#: converters must produce before dispatching to the class's kernel.
REQUIRED_FORMATS: dict = {
    DataflowClass.GEMM: (A_UMUK, B_UKUN),
    DataflowClass.SPMM: (A_UMUK, B_UNCK),
    DataflowClass.SPGEMM_INNER: (A_UMCK, B_UNCK),
    DataflowClass.SPGEMM_OUTER: (A_UKCM, B_UKCN),
    DataflowClass.SPGEMM_GUSTAVSON: (A_UKCM, B_UNCK),
}

ALL_CLASSES: Tuple[DataflowClass, ...] = tuple(DataflowClass)
