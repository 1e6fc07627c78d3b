"""Every file BENCHMARK.json names loads, and the file keeps to the
benchmark's contract as far as a test can read it."""
from __future__ import annotations

import json
import re

import pytest

from portbench import mix
from portbench.spec import ROOT, Bench

BENCH = Bench(ROOT)
SPEC = BENCH.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # A full check of 24 cells fits its 43200 s.
    assert ((2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(name) and all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"].startswith("portbench/configs/")
    d = BENCH.config(name)
    assert d["name"] == name and d["reduced"] == entry["reduced"]
    if "model" in d:
        model_config_file(d)
        return
    for key in entry["reduced"]:
        assert key in d and key in d["published"]
    from repro_torch.core.workloads import TABLE_I

    table = {w.name: w for w in TABLE_I}
    assert d["suite"] == list(table)
    for task in d["suite"]:
        w, t = table[task], mix.task(task, {}, d)
        dims = tuple(getattr(w, x) for x in "mkn")
        if task in entry["reduced"]:
            # Only n, the scale, is cut; the published sizes stay beside.
            assert tuple(d["published"][task][x] for x in "mkn") == dims
            assert (t.m, t.k) == (w.m, w.k) and t.n < w.n
        else:
            assert (t.m, t.k, t.n) == dims
        assert (t.d_mk, t.d_kn) == (w.d_mk, w.d_kn)
    from repro_torch.core import costmodel

    cfg = costmodel.config_from_json(d["accelerator"])
    assert cfg.name == name
    assert costmodel.config_to_json(cfg) == d["accelerator"]


def model_config_file(d):
    """A model configuration: the port's configuration of its name with
    the file's capacity factor and head, every published size as the file
    states it, and nothing cut."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig

    model = d["model"]
    port = get_config(d["port_config"])
    assert ModelConfig(**model) == dataclasses.replace(
        port, capacity_factor=model["capacity_factor"],
        tie_embeddings=model["tie_embeddings"])
    pub = d["published"]
    assert model["tie_embeddings"] == pub["tie_word_embeddings"]
    names = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "num_experts": "n_experts",
             "num_experts_per_tok": "experts_per_token",
             "rope_theta": "rope_theta"}
    assert {k: pub[k] for k in names} == {k: model[v]
                                         for k, v in names.items()}
    assert model["d_head"] * model["n_heads"] == pub["hidden_size"]
    # Dropless: capacity int(S * k * cf / E) equals the sequence.
    assert model["capacity_factor"] == (model["n_experts"]
                                        / model["experts_per_token"])
    assert d["reduced"] == [] and d["departures"]


ACCELERATORS = [n for n in CONFIGS if "accelerator" in BENCH.config(n)]


def test_frozen_designs_and_cut():
    """The clusters and the one cut as the paper's designs give them."""
    pes = {n: [c["pes"] for c in BENCH.config(n)["accelerator"]["clusters"]]
           for n in ACCELERATORS}
    assert pes == {"aespa_opt": [6479, 1272, 1871, 1040],
                   "aespa_equal4": [4320, 2544, 1248, 3008]}
    for n in ACCELERATORS:
        d = BENCH.config(n)
        bibd = d["bibd_81_3"]
        # Only n is cut; m and k keep their published sizes.
        assert (bibd["m"], bibd["k"], bibd["n"]) == (3200, 85000, 16000)
        assert d["published"] == {"bibd_81_3": {"m": 3200, "k": 85000,
                                                "n": 43000}}


@pytest.mark.parametrize("cell", CELLS)
def test_cells_resolve(cell):
    """A cell's config, traffic mix, generator, reference, limits and
    every metric reader are found by name."""
    w = BENCH.cell(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200
    config = BENCH.config(w["config"])
    m = BENCH.traffic(w["traffic"])
    gen = BENCH.generator(m["kind"])
    assert issubclass(gen.Traffic, mix.Traffic)
    BENCH.reference(config["reference"])
    assert BENCH.reference_limits(config["reference"])
    for trace in (False, True):
        found = BENCH.metrics(cell, trace)
        assert found
        for metric in found:
            assert callable(BENCH.reader(metric["name"]))
    e2e = {x["name"] for x in BENCH.metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("mix_name", sorted(
    p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json")))
def test_traffic_files(mix_name):
    """Each mix's traffic as a cell of it builds it: a queue alternates
    operand sets, a decode batch keeps one cache; the traced units cover
    every set."""
    m = BENCH.traffic(mix_name)
    assert (ROOT / "portbench" / "traffic" / f"{m['kind']}.py").exists()
    cell = next(w for w in SPEC["workloads"] if w["traffic"] == mix_name)
    config = BENCH.config(cell["config"])
    traffic = BENCH.generator(m["kind"]).Traffic(m, config, None, "cpu")
    assert traffic.n_sets >= (2 if m["kind"] == "queue" else 1)
    assert m["profile_units"] % traffic.n_sets == 0
    assert m["check_units"] >= 1


def test_small_mix_is_generate_traces_draw():
    """small_lpt's tasks are the order generate_trace(64, seed=1) draws,
    with its templates' dims and densities."""
    from repro_torch.serve.cluster import generate_trace

    m = BENCH.traffic("small_lpt")
    trace = generate_trace(64, seed=1)
    assert m["tasks"] == [r.workload.name for r in trace]
    for r in trace:
        t = m["templates"][r.workload.name]
        w = r.workload
        assert (t["m"], t["k"], t["n"], t["d_mk"], t["d_kn"]) == (
            w.m, w.k, w.n, w.d_mk, w.d_kn)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entries(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert NAME.match(metric) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["moves"] in {x["name"] for x in SPEC["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert callable(BENCH.reader(metric))


def test_every_cell_reports_setup_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in BENCH.metrics(cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = BENCH.metrics(cell, True)
        assert layers and all(m["moves"] in e2e for m in layers)


def test_each_cell_gets_its_metrics():
    """The model cell its own end-to-end and per-layer metrics and the
    shared two; the AESPA cells the sets they had before it came."""
    table = {"queue_ms", "queue_p95_ms", "peak_mem_gib", "setup_s"}
    table_layers = {"kernel_ms", "torch_ops_ms", "device_idle_pct",
                    "device_roofline_pct", "queue_roofline_pct", "sched_ms",
                    "sync_ms", "host_syncs", "host_exec_ms"}
    want = {
        "aespa_opt.tableI_lpt": (table, table_layers),
        "aespa_equal4.tableI_lpt": (table, table_layers),
        "aespa_equal4.small_lpt": (
            {"queue_ms.small", "queue_p95_ms.small", "peak_mem_gib",
             "setup_s"},
            {f"{m}.small" for m in table_layers}),
        "olmoe_1b_7b.azure_conv": (
            {"queue_ms.decode", "peak_mem_gib", "setup_s"},
            {"mfu.decode", "queue_roofline_pct.decode",
             "device_idle_pct.decode", "device_roofline_pct.decode"}),
    }
    for cell, (e2e, layers) in want.items():
        assert {m["name"] for m in BENCH.metrics(cell, False)} == e2e, cell
        assert {m["name"] for m in BENCH.metrics(cell, True)} == layers, cell


def test_split_metrics_share_their_reader():
    """A metric split by cells (``queue_ms.small``) without a file of its
    own is read by ``queue_ms.py``."""
    assert not (ROOT / "portbench" / "metrics" / "queue_ms.small.py").exists()
    assert BENCH.reader("queue_ms.small").__module__ == (
        BENCH.reader("queue_ms").__module__)


def test_json_files_parse():
    for p in (ROOT / "portbench").rglob("*.json"):
        json.loads(p.read_text())
