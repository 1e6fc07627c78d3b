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
def test_control_fails_at_the_cells_size(card):
    from portbench import calibrate

    limit = BENCH.reference_limits("matmul_f64")["max_rel_err"]
    rows = calibrate.readings("aespa_opt.tableI_lpt", [2 ** 31 + 902],
                              card, out=lambda line: None)
    by_side = {r["side"]: r["max_rel_err"] for r in rows}
    assert by_side["program"] < limit < by_side["control"]
