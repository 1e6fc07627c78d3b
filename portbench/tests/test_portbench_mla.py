"""The latent-attention cell's files: the work count
(``lm_work_mla``), the ``decode_latent`` traffic reading the latent
cache, the configuration building with the port's zoo, the
``mla_host_ms`` reader, the frozen mix, a run through ``cell.run`` and
planted faults (``mla_faults``), on the CPU at small sizes."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench import cell, lm_work_mla
from portbench.cell import Record
from portbench.devtrace import UNIT_RANGE, WINDOW_RANGE, Event, Trace
from portbench.spec import ROOT, Bench

BENCH = Bench(ROOT)
REF = BENCH.reference("deepseek_v2_f32")
CELL = "deepseek_v2_lite.long_chat"

#: ``deepseek_v2_lite.reduced()``'s sizes in float32.
SMALL = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "d_head": 24, "d_ff": 32, "vocab_size": 512, "n_experts": 8,
         "experts_per_token": 3, "d_ff_dense": 96, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "yarn_factor": 4.0, "yarn_original_len": 16, "dtype": "float32"}


def hand_model(**kw) -> dict:
    model = {"name": "hand", "family": "moe", "n_layers": 3, "d_model": 8,
             "n_heads": 2, "n_kv_heads": 2, "d_head": 6, "d_ff": 4,
             "vocab_size": 10, "n_experts": 4, "experts_per_token": 2,
             "n_shared_experts": 1, "router_scoring": "softmax",
             "first_dense_layers": 1, "d_ff_dense": 6,
             "layer_pattern": ["mla"], "kv_lora_rank": 6,
             "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 4,
             "tie_embeddings": False, "dtype": "bfloat16"}
    model.update(kw)
    return model


def test_lm_work_mla_by_hand():
    model = hand_model()
    c = lm_work_mla.counts(model, "bfloat16")
    # MLA a layer: wq 8*2*6 = 96, wkv_a 8*8 = 64, wkv_b 6*2*8 = 96, wo
    # 2*4*8 = 64 (320 in matrices) and kv_norm 6; norms 2 * 8. Layer 0's
    # dense FFN 3 * 8 * 6 = 144. An MoE layer: a router 8 * 4 in float32,
    # the shared SwiGLU 3 * 8 * 4 = 96, experts 4 * 3 * 8 * 4 = 384. (A
    # kv_lora_rank equal to n_experts would read wkv_b as experts.)
    lead = 2 * (320 + 6 + 16 + 144)
    moe_layer = 2 * (320 + 6 + 16 + 96) + 4 * 32
    # The table and untied head, 10 * 8 each unpadded; the final norm.
    assert c.weight_bytes == lead + 2 * moe_layer + 2 * (80 + 80 + 8)
    assert c.expert_bytes == 2 * 2 * 384
    assert c.table_row_bytes == 2 * 8
    # A token: 320 + 144, then 320 + 32 + 96 and half the experts a layer,
    # then the head.
    assert c.token_params == (320 + 144) + 2 * (320 + 32 + 96 + 192) + 80
    # A position's c (6) and k_pe (2) in 3 layers, bfloat16.
    assert (c.mla_layers, c.latent_bytes) == (3, 3 * 8 * 2)
    assert lm_work_mla.flops_per_key(model) == 2 * (2 * 8 + 2 * 6)
    w = lm_work_mla.step_work(model, [3, 5])
    keys = 3 + 5 + 2
    assert w.flops == 2 * 2 * c.token_params + 3 * 56 * keys
    # The table's 8 rows not looked up are not read; experts at their
    # expected share, 1 - (1 - 2/4)^2 = 0.75; logits 2 rows of 10.
    assert w.nbytes == (c.weight_bytes - 8 * 16 + round(0.75 * 1536)
                        + 48 * keys + 2 * 10 * 2)
    assert lm_work_mla.bound_s(model, w) == max(w.flops / 989e12,
                                                w.nbytes / 3.35e12)


def test_the_expected_expert_share():
    model = {"experts_per_token": 6, "n_experts": 64}
    assert lm_work_mla.expert_share(model, 1) == pytest.approx(6 / 64)
    assert lm_work_mla.expert_share(model, 24) == pytest.approx(
        1 - (58 / 64) ** 24)
    assert 0.90 < lm_work_mla.expert_share(model, 24) < 0.91


def test_the_cells_step_is_bound_by_its_bytes():
    """At the cell's sizes: 31.4 GB of weights, 31104 bytes of latent a
    position, and a mean step bound near 10 ms, set by its bytes."""
    config = BENCH.config("deepseek_v2_lite")
    model, mix = config["model"], BENCH.traffic("long_chat")
    c = lm_work_mla.counts(model, config["cache_dtype"])
    total = c.weight_bytes + c.expert_bytes
    assert total / 1e9 == pytest.approx(31.4, abs=0.05)
    assert (c.mla_layers, c.latent_bytes) == (27, 31104)
    w = lm_work_mla.step_work(model, mix["positions"], config["cache_dtype"])
    assert w.nbytes / 3.35e12 > 10 * w.flops / 989e12
    assert 9.5e-3 < lm_work_mla.bound_s(model, w) < 11e-3


def test_the_config_file_is_the_published_model():
    """The file's ``model`` is the port's registered configuration and
    builds with its zoo; the published keys sit at the top level, and
    each size the port takes from them agrees."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla, zoo
    from repro_torch.models.config import ModelConfig

    d = BENCH.config("deepseek_v2_lite")
    cfg = ModelConfig(**d["model"])
    assert cfg == get_config(d["port_config"])
    built = zoo.build(cfg)
    assert built.padded_vocab == 102400
    pairs = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "moe_intermediate_size": "d_ff",
             "intermediate_size": "d_ff_dense", "vocab_size": "vocab_size",
             "n_routed_experts": "n_experts",
             "num_experts_per_tok": "experts_per_token",
             "n_shared_experts": "n_shared_experts",
             "first_k_dense_replace": "first_dense_layers",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "rope_theta": "rope_theta",
             "rms_norm_eps": "norm_eps"}
    for key, field in pairs.items():
        assert d[key] == getattr(cfg, field), key
    assert d["published"] == {k: d[k] for k in d["published"]}
    rs = d["rope_scaling"]
    assert (rs["type"], rs["factor"], rs["original_max_position_embeddings"],
            rs["beta_fast"], rs["beta_slow"], rs["mscale"],
            rs["mscale_all_dim"]) == (
        "yarn", cfg.yarn_factor, cfg.yarn_original_len, mla.BETA_FAST,
        mla.BETA_SLOW, mla.MSCALE, mla.MSCALE) == (
        "yarn", cfg.yarn_factor, cfg.yarn_original_len, REF.BETA_FAST,
        REF.BETA_SLOW, REF.MSCALE, REF.MSCALE_ALL_DIM)
    # The port and the reference apply no routed scaling: it is 1.
    assert d["routed_scaling_factor"] == 1
    assert d["q_lora_rank"] is None and d["scoring_func"] == "softmax"
    assert d["norm_topk_prob"] is False and cfg.router_scoring == "softmax"
    assert d["tie_word_embeddings"] is cfg.tie_embeddings is False
    assert d["reduced"] == [] and d["departures"]
    # Dropless prefill: int(S * k * cf / E) >= S.
    assert cfg.capacity_factor * cfg.experts_per_token >= cfg.n_experts


def test_the_mix_is_its_recorded_draw():
    np = pytest.importorskip("numpy")
    mix = BENCH.traffic("long_chat")
    assert mix["kind"] == "decode_latent"
    assert (len(mix["positions"]), mix["s_max"], mix["cycle"]) == (
        24, 16384, 64)
    x = np.random.default_rng(2407).lognormal(np.log(6144), 0.7, 24)
    want = np.clip(np.rint(x), 1024, 16384 - 64).astype(int)
    assert mix["positions"] == want.tolist()


def small_root(tmp_path, check_units=3):
    """A copy of the benchmark with the cell's model at ``SMALL`` and its
    mix cut to 6 sessions in slots of 72."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    p = root / "portbench" / "configs" / "deepseek_v2_lite.json"
    d = json.loads(p.read_text())
    d["model"].update(SMALL)
    d["cache_dtype"] = "float32"
    p.write_text(json.dumps(d))
    p = root / "portbench" / "traffic" / "long_chat.json"
    m = json.loads(p.read_text())
    m["positions"] = [max(1, x // 256) for x in m["positions"][:6]]
    m.update(cycle=8, s_max=72, check_units=check_units, profile_units=1)
    p.write_text(json.dumps(m))
    return root


def small_traffic(tmp_path, seed=1):
    bench = Bench(small_root(tmp_path))
    config = bench.config("deepseek_v2_lite")
    mix = bench.traffic("long_chat")
    traffic = bench.generator(mix["kind"]).Traffic(mix, config, None, "cpu")
    traffic.prepare(torch.Generator().manual_seed(seed))
    return traffic


def test_written_reads_the_latent_leaves(tmp_path):
    """A unit's third output is each layer's ``c`` and ``k_pe`` at each
    session's position, the leading layer first, read from the cache the
    step returned."""
    traffic = small_traffic(tmp_path)
    logits, pos, written = traffic.run(0)
    cache = traffic.cache
    assert set(cache["blocks"]["s0"]) == {"c", "k_pe"}
    rows = torch.arange(6)
    lead = cache["lead"][0]
    want = [torch.cat([lead["c"][rows, pos], lead["k_pe"][rows, pos]], -1)]
    s0 = cache["blocks"]["s0"]
    want += list(torch.cat([s0["c"][:, rows, pos], s0["k_pe"][:, rows, pos]],
                           -1))
    assert written.shape == (3, 6, 32 + 8)
    assert torch.equal(written, torch.stack(want))
    assert torch.equal(pos, torch.tensor(traffic.start, dtype=torch.int32))
    assert logits.shape == (6, 512)
    # What a step wrote is not what the slot held before it.
    assert bool(written.abs().sum(-1).gt(0).all())


def test_the_traffics_work_is_the_latent_count(tmp_path):
    traffic = small_traffic(tmp_path)
    model = traffic.config["model"]
    works = [lm_work_mla.step_work(model, [p + j for p in traffic.start],
                                   "float32") for j in range(traffic.cycle)]
    assert traffic.bound == pytest.approx(
        sum(lm_work_mla.bound_s(model, w) for w in works) / len(works))
    assert traffic.flops == pytest.approx(
        sum(lm_work_mla.flops_s(model, w) for w in works) / len(works))


def canned(host):
    return Trace(device=[Event("void kernel()", 0, 5)],
                 host=[Event(WINDOW_RANGE, 0, 1000),
                       Event(UNIT_RANGE, 0, 500), Event(UNIT_RANGE, 500, 1000),
                       *host], start_us=0, end_us=1000, units=2)


def test_mla_host_ms_reads_the_latent_spans():
    read = BENCH.reader("mla_host_ms.decode")
    assert read is BENCH.reader("mla_host_ms") or (
        read.__module__ == BENCH.reader("mla_host_ms").__module__)
    rec = Record(trace=canned([
        Event("repro.mla.decode", 10, 60), Event("aten::mm", 20, 30),
        Event("repro.mla.decode", 510, 530),
        Event("repro.moe.shared", 100, 400),
        Event("repro.mla.prefill", 990, 1100)]))
    # 50 + 20 + 10 (cut by the window) us over 2 steps.
    assert read(rec) == pytest.approx(0.080 / 2)
    # No latent span, or no program span at all: nothing to read.
    assert read(Record(trace=canned([Event("repro.moe.shared", 1, 2)]))) \
        is None
    assert read(Record(trace=canned([]))) is None
    assert read(Record()) is None


def test_mla_host_ms_reads_a_captured_steps_replay():
    """A captured step issues the latent attention in its replay: the
    ``repro.decode.replay`` spans are read, with any latent span."""
    read = BENCH.reader("mla_host_ms.decode")
    rec = Record(trace=canned([
        Event("repro.decode.replay", 10, 40), Event("aten::copy_", 5, 8),
        Event("repro.decode.replay", 510, 560)]))
    assert read(rec) == pytest.approx(0.080 / 2)


@pytest.mark.card
def test_the_captured_step_repeats_the_eager_one_on_the_card(card):
    """On the card the captured latent step gives the eager functional
    step's logits and cache bit for bit over six steps: one capture,
    then replays."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs import get_reduced
    from repro_torch.models import build
    from repro_torch.serve import engine

    cfg = dataclasses.replace(get_reduced("deepseek-v2-lite"),
                              dtype="bfloat16")
    m = build(cfg)
    p = m.init(torch.Generator(device="cuda").manual_seed(3), "cuda")
    tok = torch.randint(0, cfg.vocab_size, (4, 24), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(4))
    pre = engine.make_prefill(m, with_cache=True)
    step = engine.make_decode_step(m)
    graphed = engine.make_decode_step(m, graph=True)
    with torch.inference_mode():
        _, want = pre(p, m.init_cache(4, 32, device="cuda"), tok[:, :16])
        _, cache = pre(p, m.init_cache(4, 32, device="cuda"), tok[:, :16])
        for i in range(16, 22):
            pos = torch.arange(4, dtype=torch.int32, device="cuda") + i
            lg_want, want = step(p, want, tok[:, i:i + 1], pos)
            lg, cache = graphed(p, cache, tok[:, i:i + 1], pos)
            assert torch.equal(lg, lg_want)
    assert graphed.graph is not None
    for a, b in zip(tree_leaves(cache), tree_leaves(want)):
        assert torch.equal(a, b)


def test_a_traced_cpu_run_of_the_cell(tmp_path):
    """Set-up, window, trace and check through ``cell.run``: correct, the
    cell's metrics, the latent spans read."""
    root = small_root(tmp_path)
    result = cell.run(CELL, 2 ** 31 + 77, 0.3, True, device="cpu",
                      root=root, log=lambda msg: None)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] % 6 == 0 and result["attempted"] > 0
    assert {"mfu.decode", "queue_roofline_pct.decode",
            "mla_host_ms.decode"} <= set(result["metrics"])
    assert set(result["checks"]) == {"logit_gap_mean", "logit_err_median",
                                     "cache_err_median"}
    plain = cell.run(CELL, 2 ** 31 + 78, 0.3, False, device="cpu",
                     root=root, log=lambda msg: None)
    assert set(plain["metrics"]) == {"queue_ms.decode", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "no_rope_score",
                                   "latent_before_norm", "plain_rope"])
def test_a_fault_planted_in_the_latent_path_is_caught(fault, tmp_path):
    from portbench import mla_faults

    root = small_root(tmp_path)
    with mla_faults.planted(fault):
        result = cell.run(CELL, 2 ** 31 + 79, 0.2, False, device="cpu",
                          root=root, log=lambda msg: None)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.card
def test_olmoes_digest_repeats_across_processes(card):
    """``digest.py`` gives one digest of OLMoE's first steps for one seed
    in two processes, so the same command in two checkouts compares
    their outputs bit for bit."""
    import subprocess
    import sys

    cmd = [sys.executable, "portbench/digest.py", "--workload",
           "olmoe_1b_7b.azure_conv", "--seed", str(2 ** 31 + 905),
           "--units", "4"]
    got = [json.loads(subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
        check=True).stdout.strip().splitlines()[-1])["sha256"]
        for _ in range(2)]
    assert got[0] == got[1]
