"""The canonical AESPA configuration the single-kernel path runs on,
copied from ``repro.core.dse``. The ``aespa_opt`` search is not ported yet
(ROADMAP.md); a searched design carries across through
``costmodel.config_from_json``.
"""
from __future__ import annotations

from repro_torch.core import costmodel as cm
from repro_torch.core import hwdb
from repro_torch.formats.taxonomy import DataflowClass


def aespa_equal4(hbm_bw: float = None) -> cm.AcceleratorConfig:
    """Equal areas for TPU/EIE/ExTensor/OuterSPACE — lands within ~1% of
    Fig 1's 11008-PE AESPA row (17280/4+10176/4+4992/4+12032/4 = 11120)."""
    return cm.aespa_from_fractions(
        {
            DataflowClass.GEMM: 0.25,
            DataflowClass.SPMM: 0.25,
            DataflowClass.SPGEMM_INNER: 0.25,
            DataflowClass.SPGEMM_OUTER: 0.25,
        },
        name="aespa_equal4",
        hbm_bw=hwdb.HBM_BW if hbm_bw is None else hbm_bw,
    )
