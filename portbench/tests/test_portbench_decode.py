"""The model cell on the CPU at the port's reduced OLMoE sizes: the decode
traffic against the plain reference, the inputs it draws, the work it
counts, a whole run through ``cell.run``, and faults planted under the
timed path that the check has to catch."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import cell, lm_inputs, lm_work
from portbench.spec import ROOT, Bench

CELL = "olmoe_1b_7b.azure_conv"
BENCH = Bench(ROOT)
REF = BENCH.reference("olmoe_f32")


def small_config(small_model) -> dict:
    config = BENCH.config("olmoe_1b_7b")
    config["model"].update(small_model)
    config["cache_dtype"] = "float32"
    return config


def small_traffic(small_model, seed=5, **mix_kw):
    """The decode traffic on four ragged sessions, a cycle of 8 steps."""
    mix = BENCH.traffic("azure_conv")
    mix.update(positions=[5, 9, 16, 12], s_max=24, cycle=8)
    mix.update(mix_kw)
    traffic = BENCH.generator("decode").Traffic(
        mix, small_config(small_model), None, "cpu")
    traffic.prepare(torch.Generator().manual_seed(seed))
    return traffic


def test_decode_logits_equal_the_reference_across_a_wrap(small_model):
    """Twelve steps (a cycle of 8 and 4 more) on sessions of four
    starts, each step's logits and the keys and values it wrote against
    the float32 forward over the session's prompt to its start and the
    tokens fed since."""
    traffic = small_traffic(small_model)
    inputs = traffic.operands(0)[0]
    layers = small_model["n_layers"]
    for i in range(12):
        logits, pos, written = traffic.run(0)
        j = i % 8
        assert pos.tolist() == [p + j for p in traffic.start]
        assert written.shape == (2, layers, 4, small_model["n_kv_heads"],
                                 small_model["d_head"])
        seqs = [torch.cat([inputs["prompts"][b, :p0],
                           inputs["fed"][b, :j + 1]])
                for b, p0 in enumerate(traffic.start)]
        want, kv = REF.forward(inputs["weights"], inputs["model"], seqs,
                               [[p] for p in pos.tolist()])
        torch.testing.assert_close(logits, torch.cat(want), rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(written, torch.cat(kv, dim=2),
                                   rtol=1e-4, atol=1e-4)


def test_readings_of_sound_and_control_outputs(small_model):
    """The program's numbers read rounding alone; the control's, the
    hidden state rounded to float8, read far more."""
    traffic = small_traffic(small_model)
    outs = []
    for _ in range(10):
        outs += traffic.run(0)
    handed = traffic.operands(0) * 10
    nums, per_token = REF.readings(outs, handed, "cpu")
    assert len(per_token) == 10 * 4
    assert nums["logit_gap_max"] == 0.0 and nums["logit_err_max"] < 1e-5
    assert nums["kv_err_max"] < 1e-5
    control, _ = REF.readings(REF.control_outputs(outs, handed, "cpu"),
                              handed, "cpu")
    assert control["logit_err_max"] > 1e3 * nums["logit_err_max"]
    assert control["kv_err_median"] > 1e3 * nums["kv_err_max"]


def test_token_numbers_by_hand():
    ref = torch.tensor([0.0, 3.0, -1.0, 2.5])
    got = torch.tensor([0.0, 2.0, -1.0, 2.9])
    # The program puts token 3 first: 0.5 below the reference's best.
    assert REF.token_numbers(got, ref) == pytest.approx(
        {"gap": 0.5, "err": 1.0 / 4.0})
    # Keys and values 3, 4 against 3, 0: |(0, 4)| / |(3, 4)|.
    ref_kv = torch.tensor([3.0, 4.0])
    assert REF.token_numbers(got, ref, torch.tensor([3.0, 0.0]),
                             ref_kv)["kv_err"] == pytest.approx(0.8)
    nums = REF.summary([{"gap": 0.5, "err": 0.25, "kv_err": 0.8},
                        {"gap": 0.0, "err": 0.1, "kv_err": 0.02},
                        {"gap": 0.0, "err": 0.0, "kv_err": 0.01}])
    assert nums == pytest.approx({
        "logit_gap_mean": 0.5 / 3, "logit_err_median": 0.1,
        "kv_err_median": 0.02, "logit_gap_max": 0.5, "logit_err_max": 0.25,
        "kv_err_max": 0.8, "flip_share": 1 / 3})
    # A position with no finite answer, or none of the right shape, fails
    # on its own, in every number compared.
    for bad in (None, torch.tensor([0.0, float("nan"), 0, 0]),
                torch.zeros(3)):
        t = REF.token_numbers(bad, ref)
        assert all(t[k] == float("inf") for k in REF.COMPARED)
    for bad in (None, torch.tensor([float("inf"), 0.0]), torch.zeros(3)):
        t = REF.token_numbers(got, ref, bad, ref_kv)
        assert all(t[k] == float("inf") for k in REF.COMPARED)


def test_a_capacity_factor_of_e_over_k_drops_no_token_at_prefill(
        small_model):
    """The port's MoE layer at capacity factor E/k equals the
    reference's dropless one on a router that sends every token to the
    same experts; the default factor of 1.25 drops tokens there."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig

    model = small_config(small_model)["model"]
    cfg = ModelConfig(**model)
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, cfg, torch.float32)
    p["router"][:, :2] += 5.0          # every token picks experts 0 and 1
    x = torch.randn(2, 32, cfg.d_model, generator=gen)
    want = REF._experts(x.reshape(64, -1), p, model).reshape(x.shape)
    got, _ = moe.moe_mlp(p, x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dropped, _ = moe.moe_mlp(
        p, x, dataclasses.replace(cfg, capacity_factor=1.25))
    assert not torch.allclose(dropped, want, rtol=1e-3, atol=1e-3)


def test_weights_take_the_ports_layout_and_follow_the_seed(small_model):
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.models import zoo
    from repro_torch.models.config import ModelConfig

    model = dict(small_config(small_model)["model"], dtype="bfloat16",
                 d_model=256, d_ff=512, d_head=64)
    got = lm_inputs.draw_weights(model, torch.Generator().manual_seed(1))
    want = zoo.build(ModelConfig(**model)).abstract_params()
    shapes = tree_map(lambda t: (tuple(t.shape), t.dtype), got)
    assert shapes == tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    # Each matrix at its fan-in's scale: a layer's d_model, an expert's
    # d_model into it and d_ff out of it; the token table at 0.02; the
    # norms about 1.
    block = got["blocks"]["s0"]
    scale = {"wq": 256, "wo": 256, "router": 256}
    for name, fan_in in scale.items():
        leaf = block["attn" if name != "router" else "ffn"][name]
        assert float(leaf.float().std()) == pytest.approx(fan_in ** -0.5,
                                                          rel=0.05)
    for name, fan_in in (("wi", 256), ("wg", 256), ("wo", 512)):
        assert float(block["ffn"][name].float().std()) == pytest.approx(
            fan_in ** -0.5, rel=0.05)
    assert float(got["embed"]["tok"].float().std()) == pytest.approx(
        0.02, rel=0.05)
    assert float(block["norm1"].float().mean()) == pytest.approx(1.0,
                                                                 abs=0.02)
    again = lm_inputs.draw_weights(model, torch.Generator().manual_seed(1))
    other = lm_inputs.draw_weights(model, torch.Generator().manual_seed(2))
    for a, b, c in zip(tree_leaves(got), tree_leaves(again),
                       tree_leaves(other)):
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_the_mix_fixes_the_work_and_the_seed_the_values(small_model):
    """Positions come from the mix whatever the seed; the tokens from the
    seed."""
    a = small_traffic(small_model, seed=1)
    b = small_traffic(small_model, seed=2)
    assert a.start == b.start == [5, 9, 16, 12]
    assert a.bound == b.bound and a.flops == b.flops
    # Prompts run to the slots' end here (24 < 256), past each start.
    assert a.prompt == [24] * 4
    assert a.prompts.shape == b.prompts.shape == (4, 24)
    assert not torch.equal(a.prompts, b.prompts)
    assert int(a.prompts.max()) < small_model["vocab_size"]
    mix = BENCH.traffic("azure_conv")
    assert len(mix["positions"]) == 32 and mix["s_max"] == 4096
    assert 1 <= min(mix["positions"])
    assert max(mix["positions"]) + mix["cycle"] <= mix["s_max"]


def test_the_mix_is_its_recorded_draw():
    """The frozen positions are the draw ``positions_drawn`` describes."""
    np = pytest.importorskip("numpy")
    mix = BENCH.traffic("azure_conv")
    n, top = len(mix["positions"]), mix["s_max"] - mix["cycle"]
    rng = np.random.default_rng(2311)
    prompt = rng.lognormal(np.log(1020), 0.6, n)
    output = rng.lognormal(np.log(129), 1.0, n)
    share = rng.random(n)
    want = np.clip(np.rint(prompt + share * output), 1, top).astype(int)
    assert mix["positions"] == want.tolist()


def test_traffic_refuses_positions_outside_the_cache(small_model):
    with pytest.raises(ValueError):
        small_traffic(small_model, positions=[5, 20], s_max=24)


def hand_model(**kw) -> dict:
    model = {"name": "hand", "family": "moe", "n_layers": 2, "d_model": 8,
             "n_heads": 2, "n_kv_heads": 1, "d_head": 4, "d_ff": 6,
             "vocab_size": 10, "n_experts": 4, "experts_per_token": 2,
             "tie_embeddings": True, "dtype": "bfloat16"}
    model.update(kw)
    return model


def test_lm_work_by_hand():
    model = hand_model()
    # A layer: wq 8*2*4 = 64, wk and wv 8*1*4 = 32 each, wo 2*4*8 = 64;
    # experts 4 * 3 * 8 * 6 = 576; norms 2 * 8; router 8 * 4 in float32.
    per_layer = 2 * (64 + 32 + 32 + 64 + 576 + 16) + 4 * 32
    c = lm_work.counts(model, "bfloat16")
    # The tied table (10 * 8, unpadded) and the final norm (8), bfloat16.
    assert c.weight_bytes == 2 * per_layer + 2 * (80 + 8)
    assert (c.attn_layers, c.table_row_bytes) == (2, 0)
    # A position's K and V: 1 head of 4 each, 2 layers, bfloat16.
    assert c.kv_bytes == 2 * 2 * 1 * 4 * 2
    w = lm_work.step_work(model, [3, 5])
    # A token uses 192 attention, 32 router and 2 * 144 expert parameters
    # a layer, and the 80 of the head; attention reads 3 + 5 keys and the
    # rows' own two: 4 * heads * d_head operations a key and layer.
    per_token = 2 * (192 + 32 + 2 * 144) + 80
    assert w.flops == 2 * 2 * per_token + 2 * 4 * 2 * 4 * (8 + 2)
    # Keys and values: 8 read and 2 written; logits 2 rows of 10.
    assert w.nbytes == c.weight_bytes + c.kv_bytes * (8 + 2) + 2 * 10 * 2
    assert lm_work.bound_s(model, w) == max(w.flops / 989e12,
                                            w.nbytes / 3.35e12)
    assert lm_work.flops_s(model, w) == w.flops / 989e12


def test_an_untied_table_is_read_by_the_rows_looked_up():
    model = hand_model(n_layers=1, n_kv_heads=2, tie_embeddings=False)
    tied = dict(model, tie_embeddings=True)
    # The untied model holds a head of 8 * 10 beside the table, and a
    # step of 3 rows reads 3 of the table's rows; both multiply through a
    # head of 80.
    u, t = (lm_work.counts(m, "bfloat16") for m in (model, tied))
    assert u.weight_bytes == t.weight_bytes + 2 * 80
    assert (u.table_row_bytes, u.token_params) == (2 * 8, t.token_params)
    wu, wt = (lm_work.step_work(m, [0, 1, 2]) for m in (model, tied))
    assert wu.nbytes == wt.nbytes + 2 * 3 * 8
    assert wu.flops == wt.flops


def test_olmoe_step_is_bound_by_its_bytes():
    """At the cell's sizes: 13.84 GB of weights, and a mean step bound of
    about 5.5 ms, set by its bytes."""
    config = BENCH.config("olmoe_1b_7b")
    mix = BENCH.traffic("azure_conv")
    model = config["model"]
    c = lm_work.counts(model, config["cache_dtype"])
    assert c.weight_bytes / 1e9 == pytest.approx(13.84, abs=0.01)
    assert c.kv_bytes == 16 * 2 * 16 * 128 * 2
    w = lm_work.step_work(model, mix["positions"], config["cache_dtype"])
    assert w.nbytes / 3.35e12 > 10 * w.flops / 989e12
    assert 5.0e-3 < lm_work.bound_s(model, w) < 6.0e-3


def run(root, trace=False, seed=2 ** 31 + 11, seconds=0.3):
    return cell.run(CELL, seed, seconds, trace, device="cpu", root=root,
                    log=lambda msg: None)


def test_a_model_cell_runs_through_cell_run(small_root):
    """A configuration with no accelerator: set-up, window, trace and
    check, with the cell's metrics and no others."""
    result = run(small_root, trace=True)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] % 8 == 0 and result["attempted"] > 0
    bench = Bench(small_root)
    assert set(result["metrics"]) <= {m["name"]
                                      for m in bench.metrics(CELL, True)}
    assert {"mfu.decode", "queue_roofline_pct.decode"} <= set(
        result["metrics"])
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(REF.COMPARED)
    plain = run(small_root)
    assert set(plain["metrics"]) == {"queue_ms.decode", "setup_s"}


def broken_step(monkeypatch, fault):
    """Plant ``fault`` in the port's decode step, as the traffic makes
    it."""
    from repro_torch.serve import engine

    real = engine.make_decode_step

    def make(model, axes=None):
        step = real(model, axes)

        def broken(params, cache, tokens, pos):
            logits, new = step(params, cache, tokens, pos)
            if fault == "unchanged":
                return logits, cache
            logits = logits.clone()
            if fault == "half":
                half = logits.shape[0] // 2
                logits[half:] = logits[:half].mean(dim=0, keepdim=True)
            else:
                v = model.cfg.vocab_size
                top = int(logits[0, 0, :v].argmax())
                logits[0, 0, (top + 1) % v] += 10.0
            return logits, new

        return broken

    monkeypatch.setattr(engine, "make_decode_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
def test_a_fault_under_the_timed_path_is_caught(fault, small_root,
                                                monkeypatch):
    """A step that returns its cache unchanged; half the sessions left
    out, the rest given their mean; one session's token altered where it
    is produced: the run is not correct."""
    path = small_root / "portbench" / "traffic" / "azure_conv.json"
    mix = json.loads(path.read_text())
    mix["check_units"] = 4
    path.write_text(json.dumps(mix))
    broken_step(monkeypatch, fault)
    result = run(small_root)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_reference_imports_only_torch():
    """The plain reference stands apart from the port: no module of
    ``repro_torch``, of its kernels or of JAX, and TF32 off inside."""
    import ast

    path = ROOT / "portbench" / "references" / "olmoe_f32.py"
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert {n.split(".")[0] for n in names} <= {
        "__future__", "math", "contextlib", "typing", "torch"}
    assert "allow_tf32 = False" in path.read_text()


def test_calibration_judges_a_runs_own_sample(small_root):
    """``calibrate.readings`` of the model cell: the sample a run's check
    judged, for the program, and the control's answers for the same
    units; the control reads far higher in every number but the gap."""
    from portbench import calibrate

    rows = calibrate.readings(CELL, [2 ** 31 + 5], "cpu", root=small_root,
                              out=lambda line: None, seconds=0.3)
    by_side = {r["side"]: r for r in rows}
    assert set(by_side) == {"program", "control"}
    for k in ("logit_err_median", "kv_err_median"):
        assert by_side["control"][k] > 100 * by_side["program"][k]
