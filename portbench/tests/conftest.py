"""Tests of the benchmark harness. CPU tests run the port's plain
versions at small sizes; tests marked ``card`` run on an NVIDIA card and
skip without one (decided inside the ``card`` fixture, never at import).

    python3 -m pytest -q portbench/tests            # here
    python3 -m pytest -q portbench/tests -m card    # on the card
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def small_model():
    return dict(SMALL_MODEL)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


#: A model configuration's sizes in the test copy: the port's
#: ``olmoe_1b_7b.reduced()`` in float32, dropless (capacity factor E/k).
SMALL_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
               "d_head": 16, "d_ff": 64, "vocab_size": 512, "n_experts": 8,
               "experts_per_token": 2, "capacity_factor": 4.0,
               "dtype": "float32"}


def shrink(d: dict) -> None:
    """Cut a configuration to CPU size in place. A model: the sizes of
    ``SMALL_MODEL``. An accelerator's workloads: every dim to a tenth (a
    twentieth above 5000), at least 8; densities at least 2% so each task
    has nonzeros."""
    if "model" in d:
        d["model"].update(SMALL_MODEL)
        d["cache_dtype"] = "float32"
        return
    for name in d["suite"]:
        w = d[name]
        for key in "mkn":
            w[key] = max(8, int(w[key] * (0.05 if w[key] > 5000 else 0.1)))
        w["d_mk"] = max(w["d_mk"], 0.02)
        w["d_kn"] = max(w["d_kn"], 0.02)


def shrink_sessions(m: dict) -> None:
    """A decode mix at CPU size: its first 8 sessions, their starts cut
    by 64 (at least 1), a cycle of 8 steps, slots of 48 positions."""
    m["positions"] = [max(1, p // 64) for p in m["positions"][:8]]
    m.update(cycle=8, s_max=48)


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and portbench/) whose
    configurations are cut to CPU size, each mix checking one unit and
    tracing one unit of each operand set (a decode mix has one)."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = root / c["file"]
        d = json.loads(p.read_text())
        shrink(d)
        p.write_text(json.dumps(d))
    for p in (root / "portbench" / "traffic").glob("*.json"):
        m = json.loads(p.read_text())
        m["check_units"] = 1
        m["profile_units"] = m.get("operand_sets", 1)
        if m["kind"] == "decode":
            shrink_sessions(m)
        p.write_text(json.dumps(m))
    return root
