"""On the card: one short run of each cell through the entry, and the
control at a cell's own size failing where the program passes.

    python3 -m pytest -q portbench/tests -m card
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT, Bench

BENCH = Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_one_short_run_of_each_cell(name, card):
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 901), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {
        m["name"] for m in BENCH.metrics(name, False)}
    assert done.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
@pytest.mark.parametrize("name", ["aespa_opt.tableI_lpt",
                                  "olmoe_1b_7b.azure_conv"])
def test_control_fails_at_the_cells_size(name, card):
    """The program inside every limit, the control (matmuls from TF32
    inputs; the model's hidden state rounded to float8) over one."""
    from portbench import calibrate

    config = BENCH.config(BENCH.cell(name)["config"])
    limits = BENCH.reference_limits(config["reference"])
    rows = calibrate.readings(name, [2 ** 31 + 902], card,
                              out=lambda line: None)
    by_side = {r["side"]: r for r in rows}
    assert all(by_side["program"][k] <= v for k, v in limits.items())
    assert any(by_side["control"][k] > v for k, v in limits.items())
