"""Whole runs on the CPU with the port's plain versions: a cell built from
added files alone, a fault planted in each kernel class, the entry's
refusals and the import guard."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import cell, guard
from portbench.spec import ROOT


def quiet(msg):
    pass


def run(root, name, trace=False, seed=2 ** 31 + 7):
    return cell.run(name, seed, 0.05, trace, device="cpu", root=root,
                    log=quiet)


def test_a_cell_from_new_files_alone(small_root):
    """A new configuration, traffic mix and per-layer metric, each a file
    of its own, plus entries in BENCHMARK.json; no other file changes."""
    before = {p: p.read_bytes() for p in small_root.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    pb = small_root / "portbench"
    config = {
        "name": "tiny", "source": "test", "dtype": "float32", "block": 128,
        "reference": "matmul_f64",
        "accelerator": json.loads(
            (pb / "configs" / "aespa_equal4.json").read_text())[
                "accelerator"],
        "suite": ["square"], "reduced": [],
        "square": {"m": 40, "k": 48, "n": 24, "d_mk": 0.1, "d_kn": 1.0}}
    (pb / "configs" / "tiny.json").write_text(json.dumps(config))
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps({
        "kind": "queue", "policy": "sjf", "operand_sets": 2,
        "check_units": 2, "profile_units": 2,
        "templates": {"skinny": {"m": 64, "k": 8, "n": 16, "d_mk": 0.5,
                                 "d_kn": 0.5}},
        "tasks": ["square", "skinny", "square"]}))
    (pb / "metrics" / "tasks_per_unit.py").write_text(
        "def read(rec):\n"
        "    return float(len(rec.unit_s)) if rec.trace else None\n")
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.tiny_mix", "config": "tiny",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "test"})
    # Its own end-to-end metric and layers, read by the files of the
    # names before the dot where it has no file of its own.
    spec["end_to_end"].append({"name": "queue_ms.tiny", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny.tiny_mix"]})
    for name, unit in (("tasks_per_unit", "n"),
                       ("queue_roofline_pct.tiny", "%")):
        spec["per_layer"].append({"name": name, "unit": unit,
                                  "better": "higher", "source": "host_clock",
                                  "layer": "whole queue",
                                  "moves": "queue_ms.tiny",
                                  "workloads": ["tiny.tiny_mix"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data

    plain = run(small_root, "tiny.tiny_mix")
    assert plain["correct"] and plain["failed"] == 0
    assert plain["attempted"] % 3 == 0 and plain["attempted"] > 0
    # The CPU has no allocator peak.
    assert set(plain["metrics"]) == {"queue_ms.tiny", "setup_s"}
    traced = run(small_root, "tiny.tiny_mix", trace=True)
    assert traced["correct"]
    # No device trace on the CPU: only the host-clock layers read.
    assert set(traced["metrics"]) == {"tasks_per_unit",
                                      "queue_roofline_pct.tiny"}
    assert traced["metrics"]["tasks_per_unit"]["value"] >= 1
    assert list(traced)[-1] == "checks"


#: Each kernel class's wrapper with a cell that launches it at the test
#: copy's sizes; only the small mix runs the plain, not mirrored, SpMM
#: there.
ALTERED = [("gemm", "aespa_opt.tableI_lpt"),
           ("spmm_mirror", "aespa_opt.tableI_lpt"),
           ("spgemm_inner", "aespa_opt.tableI_lpt"),
           ("spgemm_gustavson", "aespa_opt.tableI_lpt"),
           ("spgemm_outer", "aespa_equal4.tableI_lpt"),
           ("spmm", "aespa_equal4.small_lpt")]


@pytest.mark.parametrize("op,name", ALTERED)
def test_an_answer_altered_where_it_is_produced_is_caught(
        op, name, small_root, monkeypatch):
    """Each kernel class's wrapper adds a thousandth of the output's scale
    to one element of what it returns: the run is not correct."""
    from repro_torch.kernels import ops

    calls = []
    real = getattr(ops, op)

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0] += 1e-3 * (float(out.abs().max()) + 1.0)
        calls.append(op)
        return out

    monkeypatch.setattr(ops, op, altered)
    result = run(small_root, name)
    assert calls
    assert not result["correct"] and result["failed"] >= 1
    assert result["checks"]["max_rel_err"]["value"] > result["checks"][
        "max_rel_err"]["limit"]


def test_sound_runs_of_every_cell(small_root):
    """Every cell of BENCHMARK.json."""
    for w in json.loads((small_root / "BENCHMARK.json").read_text())[
            "workloads"]:
        result = run(small_root, w["name"])
        assert result["correct"], w["name"]
        assert set(result) == {"correct", "attempted", "failed", "metrics",
                               "device", "checks"}


def cli(root, env_extra=None):
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "CUDA_VISIBLE_DEVICES": ""}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload",
         "aespa_opt.tableI_lpt", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)


def test_entry_refuses_without_a_card():
    done = cli(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "no CUDA device" in done.stderr


def test_entry_refuses_without_the_port(small_root):
    """A directory with only BENCHMARK.json and portbench/."""
    done = cli(small_root)
    assert done.returncode != 0 and done.stdout == ""
    assert "port is not beside" in done.stderr


def test_report_refuses_when_jax_or_the_jax_package_is_loaded(
        monkeypatch, capsys):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run as entry
    finally:
        sys.path.remove(str(ROOT / "portbench"))
    for name in ("repro.core", "jax", "flax.linen", "jaxlib"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, types.ModuleType(name))
            assert entry.report({"correct": True}) == 1
        out = capsys.readouterr()
        assert out.out == "" and name.split(".")[0] in out.err
    assert entry.report({"correct": True}) == 0
    assert json.loads(capsys.readouterr().out) == {"correct": True}


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["repro_torch.core", "reprox", "jax_like"]) == []
    assert guard.forbidden(["repro", "jax.numpy", "repro_torch"]) == [
        "jax", "repro"]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
        assert guard.forbidden(names) == [], path
