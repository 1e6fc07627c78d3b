"""The plain reference against NumPy, the TF32 rounding of the control,
and the control itself: at a size a test run holds, the program's number
stays under the limit and the control's goes over it, on three seeds."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.spec import ROOT, Bench

REF = Bench(ROOT).reference("matmul_f64")
LIMIT = Bench(ROOT).reference_limits("matmul_f64")["max_rel_err"]


def numpy_error(out, a, b) -> float:
    want = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(out.astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(5000, 3, 2), (9, 7, 11), (1, 1, 1)])
def test_task_error_against_numpy(m, k, n, monkeypatch):
    monkeypatch.setattr(REF, "BLOCK_ROWS", 4)  # several row blocks
    rng = np.random.default_rng(3)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    out = (a @ b).astype(np.float32)
    out[m // 2, n // 2] += 0.01
    got = REF.task_error(torch.from_numpy(out), a, b, "cpu")
    assert got == pytest.approx(numpy_error(out, a, b), rel=1e-12)


def test_task_error_refuses_missing_and_broken_outputs():
    a = torch.ones(3, 4)
    b = torch.ones(4, 5)
    assert REF.task_error(None, a, b, "cpu") == math.inf
    assert REF.task_error(torch.zeros(5, 3), a, b, "cpu") == math.inf
    bad = a @ b
    bad[1, 1] = float("nan")
    assert REF.task_error(bad, a, b, "cpu") == math.inf
    assert REF.task_error(torch.zeros(3, 5), torch.zeros(3, 4), b,
                          "cpu") == 0.0


def test_readings_take_the_worst_task():
    a, b = torch.eye(3), torch.ones(3, 2)
    good, off = a @ b, a @ b + 0.5
    nums, per_task = REF.readings([good, off], [(a, b), (a, b)], "cpu")
    assert nums == {"max_rel_err": 0.5}
    assert per_task == [{"max_rel_err": 0.0}, {"max_rel_err": 0.5}]


def test_tf32_rounding():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    y = REF.to_tf32(x)
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    rel = ((y - x).abs() / x.abs()).max()
    assert 2 ** -13 < float(rel) <= 2 ** -11
    assert torch.equal(REF.to_tf32(y), y)


@pytest.mark.parametrize("cell", ["aespa_opt.tableI_lpt",
                                  "aespa_equal4.tableI_lpt",
                                  "aespa_equal4.small_lpt"])
def test_control_fails_where_the_program_passes(cell, small_root):
    from portbench import calibrate

    rows = calibrate.readings(cell, [2 ** 31 + 3, 17, 5], "cpu",
                              root=small_root, out=lambda line: None)
    program = [r["max_rel_err"] for r in rows if r["side"] == "program"]
    control = [r["max_rel_err"] for r in rows if r["side"] == "control"]
    assert len(program) == len(control) == 3
    assert max(program) < LIMIT < min(control)
