"""Compression formats of the port: the CCF taxonomy, ELL fibers on
tensors and the format converters, re-exported as ``repro.formats`` does
(``ell_onehot_expand``, a TPU expansion helper, has no counterpart), except
that the function ``convert`` stays in its module:
``repro_torch.formats.convert`` is the module."""
from repro_torch.formats.taxonomy import (
    A_UKCM,
    A_UKUM,
    A_UMCK,
    A_UMUK,
    ALL_CLASSES,
    B_UKCN,
    B_UKUN,
    B_UNCK,
    DataflowClass,
    MatrixCCF,
    PARALLELISM_BOUND,
    REQUIRED_FORMATS,
    classify,
)
from repro_torch.formats.ell import (
    PAD_ID,
    EllMatrix,
    block_chunk_counts,
    block_window_nnz,
    bucket_capacity,
    check_capacity,
    dense_to_ell,
    ell_to_dense,
    pad_capacity,
    required_capacity,
    tile_occupancy,
)
from repro_torch.formats import convert
from repro_torch.formats.convert import (
    conversion_bytes,
    major_axis_for,
    to_dense,
    to_format,
)

__all__ = [
    "A_UKCM", "A_UKUM", "A_UMCK", "A_UMUK", "ALL_CLASSES",
    "B_UKCN", "B_UKUN", "B_UNCK",
    "DataflowClass", "MatrixCCF", "PARALLELISM_BOUND", "REQUIRED_FORMATS",
    "classify", "PAD_ID", "EllMatrix", "block_chunk_counts",
    "block_window_nnz", "bucket_capacity", "check_capacity",
    "dense_to_ell", "ell_to_dense", "pad_capacity",
    "required_capacity", "tile_occupancy", "conversion_bytes", "convert",
    "major_axis_for", "to_dense", "to_format",
]
