"""DeepSeek-V2's blocks in the port (latent attention with its latent
decode cache, YaRN, the softmax router, shared experts, the leading dense
layer; ``repro_torch.models.mla`` and the ``mla`` kind of
``repro_torch.models.transformer``) against the plain float32 reference
of ``tests/deepseek_v2_reference.py``, at ``deepseek_v2_lite.reduced()``
size on seeded random weights, on the CPU. The JAX package has no such
model, so nothing here is compared with it.

Tolerances: the port and the reference both compute in float32 here (the
reduced config's dtype), so they differ only in the order of their sums
(flash's chunked online softmax against one softmax, the absorbed decode
against the expanded attention, einsums against matmuls); at these sizes
that moves a logit by at most a few 1e-6 (logits of size 1-4), so 1e-4
absolute and relative leaves a margin of ten while a planted fault (a
dropped score term, a latent cached before its norm) moves them by 1e-1
or more."""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

import deepseek_v2_reference as REF
import repro_torch.configs as tconfigs
from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import mla_decode
from repro_torch.models import build, mla, moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import Axes
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 40
TOL = dict(atol=1e-4, rtol=1e-4)


def cfg_():
    return tconfigs.get_reduced("deepseek-v2-lite")


def model_and_params(seed=0):
    cfg = cfg_()
    m = build(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(seed), device="cpu")


def tokens(cfg, seed=1, s=S):
    return torch.randint(0, cfg.vocab_size, (B, s),
                         generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def reference(params, tok, cfg):
    return REF.forward(params, tok, dataclasses.asdict(cfg))


def test_reduced_has_every_kind_and_yarn_below_the_positions():
    cfg = cfg_()
    assert cfg.lead_kinds() == ("mla",) and cfg.first_dense_layers == 1
    assert cfg.pattern_split() == (cfg.n_layers - 1, ("mla",), ())
    assert cfg.n_shared_experts and cfg.router_scoring == "softmax"
    assert 0 < cfg.yarn_original_len < S and cfg.yarn_factor > 1
    # Dropless: a capacity of int(S * k * cf / E) holds every token.
    assert int(S * cfg.experts_per_token * cfg.capacity_factor
               / cfg.n_experts) >= S


def test_forward_logits_match_the_reference():
    cfg, m, p = model_and_params()
    tok = tokens(cfg)
    got, aux = m.forward(p, {"tokens": tok})
    want, _ = reference(p, tok, cfg)
    torch.testing.assert_close(got[..., :cfg.vocab_size], want, **TOL)
    assert torch.isfinite(aux)


@pytest.mark.parametrize("prompt", [8, 24])
def test_prefill_then_decode_through_serve_engine(prompt):
    """``make_prefill(with_cache=True)`` over the prompt, then
    ``make_decode_step`` at every later position, some past YaRN's
    original length: the reference's full-forward logits at each, and
    its ``c`` and ``k_pe`` at every position in the cache returned."""
    cfg, m, p = model_and_params()
    tok = tokens(cfg)
    want, lats = reference(p, tok, cfg)
    pre = engine.make_prefill(m, with_cache=True)
    step = engine.make_decode_step(m)
    with torch.inference_mode():
        cache = m.init_cache(B, S + 8, device="cpu")
        lg, cache = pre(p, cache, tok[:, :prompt])
        torch.testing.assert_close(lg[:, 0, :cfg.vocab_size],
                                   want[:, prompt - 1], **TOL)
        for i in range(prompt, S):
            pos = torch.full((B,), i, dtype=torch.int32)
            lg, cache = step(p, cache, tok[:, i:i + 1], pos)
            torch.testing.assert_close(lg[:, 0, :cfg.vocab_size],
                                       want[:, i], **TOL)
    got = [torch.cat([cache["lead"][0]["c"], cache["lead"][0]["k_pe"]],
                     dim=-1)[None]]
    got.append(torch.cat([cache["blocks"]["s0"]["c"],
                          cache["blocks"]["s0"]["k_pe"]], dim=-1))
    torch.testing.assert_close(torch.cat(got)[:, :, :S], lats, **TOL)


def test_greedy_generate_matches_the_token_by_token_path():
    cfg, m, p = model_and_params()
    prompt = tokens(cfg, s=12)
    fast = engine.greedy_generate(m, p, prompt, 10, 32, device="cpu")
    slow = engine.greedy_generate_reference(m, p, prompt, 10, 32,
                                            device="cpu")
    assert torch.equal(fast, slow)


def test_absorbed_decode_equals_the_expanded_attention():
    """``absorbed_attend`` against a latent cache equals per-head keys and
    values expanded from the same cache, attended at the same positions."""
    cfg = cfg_()
    g = torch.Generator().manual_seed(4)
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    s_max = 24
    q_nope = torch.randn(B, h, nope, generator=g)
    q_pe = torch.randn(B, h, rope, generator=g)
    wkv_b = torch.randn(r, h, nope + dv, generator=g) / math.sqrt(r)
    c = torch.randn(B, s_max, r, generator=g)
    k_pe = torch.randn(B, s_max, rope, generator=g)
    pos = torch.tensor([5, 19])
    got = mla.absorbed_attend(q_nope, q_pe, wkv_b, c, k_pe, pos, cfg)
    kv = torch.einsum("bsc,che->bshe", c, wkv_b)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(-1, -1, h, -1)],
                  dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    s = torch.einsum("bhd,bshd->bhs", q, k) * mla.softmax_scale(cfg)
    s = s.masked_fill(torch.arange(s_max)[None, None, :]
                      > pos[:, None, None], -math.inf)
    want = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1),
                        kv[..., nope:])
    torch.testing.assert_close(got, want, **TOL)


def test_yarn_frequencies_and_scale_follow_the_published_formulas():
    """DeepSeek-V2-Lite's YaRN (factor 40, 4096 original positions,
    beta 32 and 1, mscale = mscale_all_dim = 0.707): the ramp's pairs,
    the inverse frequencies, the tables' factor and the softmax scale."""
    cfg = tconfigs.get_config("deepseek-v2-lite")
    d = dataclasses.asdict(cfg)
    assert mla.yarn_range(cfg) == REF.yarn_find_correction_range(
        32, 1, 64, 10000.0, 4096) == (10, 23)
    torch.testing.assert_close(mla.inv_freq(cfg), REF.inv_freq(d),
                               atol=0, rtol=1e-6)
    base = 10000.0 ** (-torch.arange(0, 64, 2).double() / 64)
    f = mla.inv_freq(cfg).double()
    # Below the ramp the plain frequencies, above it divided by 40.
    torch.testing.assert_close(f[:10], base[:10], rtol=1e-6, atol=0)
    torch.testing.assert_close(f[23:], base[23:] / 40, rtol=1e-6, atol=0)
    # mscale = mscale_all_dim: the cos and sin tables keep a scale of 1.
    assert REF.yarn_get_mscale(40, REF.MSCALE) == REF.yarn_get_mscale(
        40, REF.MSCALE_ALL_DIM)
    at = torch.tensor([[0, 5, 5000]])
    cos2, sin2 = mla.rope_tables(at, cfg)
    ang = at.float()[..., None] * mla.inv_freq(cfg)
    torch.testing.assert_close(cos2[0, :, 0, :32], torch.cos(ang)[0],
                               atol=0, rtol=0)
    torch.testing.assert_close(sin2[0, :, 0, 32:], torch.sin(ang)[0],
                               atol=0, rtol=0)
    want = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert mla.softmax_scale(cfg) == pytest.approx(want, rel=1e-12)
    assert REF.softmax_scale(d) == pytest.approx(want, rel=1e-12)
    plain = dataclasses.replace(cfg, yarn_factor=0.0)
    torch.testing.assert_close(mla.inv_freq(plain).double(), base,
                               rtol=1e-6, atol=0)
    assert mla.softmax_scale(plain) == 192 ** -0.5


def test_the_router_keeps_unrenormalised_softmax_shares():
    cfg = cfg_()
    g = torch.Generator().manual_seed(2)
    router = torch.randn(cfg.d_model, cfg.n_experts,
                         generator=g) / math.sqrt(cfg.d_model)
    x = torch.randn(7, cfg.d_model, generator=g)
    w, idx = moe._route(router, x, cfg)
    probs = torch.softmax(x @ router, dim=-1)
    top, want = torch.topk(probs, cfg.experts_per_token, dim=-1)
    assert torch.equal(idx.long(), want)
    torch.testing.assert_close(w, top, atol=1e-6, rtol=1e-6)
    assert bool((w.sum(-1) < 0.9).all())     # k = 3 of E = 8 shares
    # The port's default keeps its softmax over the top k.
    plain = dataclasses.replace(cfg, router_scoring="topk_softmax")
    torch.testing.assert_close(moe._route(router, x, plain)[0].sum(-1),
                               torch.ones(7))


def test_shared_experts_and_the_dense_layer_0():
    """An MoE block adds its shared SwiGLU (width ``n_shared * d_ff``) to
    the routed sum on every token; layer 0's FFN is a dense SwiGLU of
    ``d_ff_dense`` with no router."""
    cfg, m, p = model_and_params()
    lead = p["lead"][0]["ffn"]
    assert "router" not in lead and lead["wi"].shape == (cfg.d_model,
                                                         cfg.d_ff_dense)
    ffn = {k: t[0] for k, t in p["blocks"]["s0"]["ffn"].items()
           if k != "shared"}
    ffn["shared"] = {k: t[0]
                     for k, t in p["blocks"]["s0"]["ffn"]["shared"].items()}
    assert ffn["shared"]["wi"].shape == (
        cfg.d_model, cfg.n_shared_experts * cfg.d_ff)
    x = torch.randn(1, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    got, _ = moe.moe_mlp(ffn, x, cfg)
    want = (REF.moe(x, ffn, dataclasses.asdict(cfg)))
    torch.testing.assert_close(got, want, **TOL)
    routed, _ = moe.moe_mlp({k: v for k, v in ffn.items() if k != "shared"},
                            x, cfg)
    torch.testing.assert_close(got - routed, REF.swiglu(x, ffn["shared"]),
                               **TOL)


def test_the_latent_cache_holds_c_and_k_pe_only():
    cfg, m, _ = model_and_params()
    cache = m.init_cache(3, 16, device="cpu")
    assert set(cache) == {"lead", "blocks", "tail"}
    assert cache["tail"] == []
    stacked = cache["blocks"]["s0"]
    assert set(stacked) == {"c", "k_pe"} == set(cache["lead"][0])
    assert stacked["c"].shape == (cfg.n_layers - 1, 3, 16, cfg.kv_lora_rank)
    assert stacked["k_pe"].shape == (cfg.n_layers - 1, 3, 16,
                                     cfg.qk_rope_head_dim)
    assert cache["lead"][0]["c"].shape == (3, 16, cfg.kv_lora_rank)


@pytest.mark.parametrize("where", ["blocks", "lead"])
def test_cache_len_finds_the_latent_cache(where):
    """``_cache_len`` reads S_max off a latent cache, stacked or not, so
    ``decode_step`` checks positions for MLA as for GQA."""
    cfg, m, _ = model_and_params()
    cache = m.init_cache(B, 16, device="cpu")
    if where == "lead":
        cache["blocks"] = {}
    assert T._cache_len(cache) == 16


def test_decode_step_raises_past_the_latent_cache():
    cfg, m, p = model_and_params()
    cache = m.init_cache(B, 8, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the cache"):
        m.decode_step(p, cache, tok, torch.tensor([3, 8], dtype=torch.int32))


def test_the_in_place_step_equals_the_functional_one():
    """``make_decode_step(graph=True)`` (on the CPU the in-place step,
    eagerly) gives the functional step's logits bit for bit over several
    steps, writes the cache it is given and returns that cache, whose
    leaves equal the functional step's new cache."""
    cfg, m, p = model_and_params()
    tok = tokens(cfg)
    pre = engine.make_prefill(m, with_cache=True)
    step = engine.make_decode_step(m)
    graphed = engine.make_decode_step(m, graph=True)
    with torch.inference_mode():
        _, want = pre(p, m.init_cache(B, S, device="cpu"), tok[:, :8])
        _, cache = pre(p, m.init_cache(B, S, device="cpu"), tok[:, :8])
        for i in range(8, 14):
            pos = torch.tensor([i, i + 3], dtype=torch.int32)
            lg_want, want = step(p, want, tok[:, i:i + 1], pos)
            lg, got = graphed(p, cache, tok[:, i:i + 1], pos)
            assert got is cache
            assert torch.equal(lg, lg_want)
    for a, b in zip(tree_leaves(cache), tree_leaves(want)):
        assert torch.equal(a, b)


def test_the_in_place_step_bounds_its_positions_and_kinds():
    cfg, m, p = model_and_params()
    tok = torch.zeros((B, 1), dtype=torch.int32)
    graphed = engine.make_decode_step(m, graph=True)
    with pytest.raises(ValueError, match="outside the cache"):
        graphed(p, m.init_cache(B, 8, device="cpu"), tok,
                torch.tensor([3, 8], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="mesh"):
        engine.make_decode_step(m, axes=Axes(), graph=True)
    olmoe = build(tconfigs.get_reduced("olmoe-1b-7b"))
    po = olmoe.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        T.decode_step(po, olmoe.init_cache(B, 8, device="cpu"), tok,
                      torch.zeros((B,), dtype=torch.int32), olmoe.cfg,
                      in_place=True)


def test_the_mesh_path_raises_naming_mla():
    cfg, m, p = model_and_params()
    with pytest.raises(NotImplementedError, match="MLA"):
        m.forward(p, {"tokens": tokens(cfg)}, axes=Axes())
    with pytest.raises(NotImplementedError, match="MLA"):
        m.decode_step(p, m.init_cache(B, 8, device="cpu"),
                      torch.zeros((B, 1), dtype=torch.int32),
                      torch.zeros((B,), dtype=torch.int32), axes=Axes())


def test_published_config_counts_and_abstract_tree():
    """The published widths build on the meta device: 15.70 B parameters,
    no per-head key or value in the cache."""
    cfg = tconfigs.get_config("deepseek-v2-lite")
    m = build(cfg)
    tree = m.abstract_params()
    n = sum(t.numel() for t in tree_leaves(tree))
    # param_count leaves out the routers and the norms' scales.
    assert n == (cfg.param_count()
                 + (cfg.n_layers - 1) * cfg.d_model * cfg.n_experts
                 + 2 * cfg.n_layers * cfg.d_model + cfg.d_model)
    assert 15.6e9 < n < 15.8e9
    cache = T.init_cache(cfg, 1, 4, device="meta")
    assert set(cache["blocks"]["s0"]) == {"c", "k_pe"}
    per_position = sum(t.numel() * t.element_size()
                       for t in tree_leaves(cache)) // 4
    assert per_position == 31104        # 576 bfloat16 values, 27 layers


def test_the_benchmarks_copy_gives_the_tests_logits():
    """``portbench/references/deepseek_v2_f32.py`` (the cell's reference,
    in blocks of queries) gives this file's reference's logits and
    latents, per session and position."""
    spec = importlib.util.spec_from_file_location(
        "deepseek_v2_f32", ROOT / "portbench" / "references"
        / "deepseek_v2_f32.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.QUERY_BLOCK = 16          # several blocks over S = 40
    cfg, _, p = model_and_params()
    tok = tokens(cfg)
    want, lats = reference(p, tok, cfg)
    at = [[3, 17, 39], [0, 25]]
    got, got_lat = bench.forward(p, dataclasses.asdict(cfg), list(tok), at)
    for b, ps in enumerate(at):
        torch.testing.assert_close(got[b], want[b, ps], **TOL)
        torch.testing.assert_close(got_lat[b], lats[:, b, ps], **TOL)


@pytest.mark.parametrize("path", [
    "tests/deepseek_v2_reference.py",
    "portbench/references/deepseek_v2_f32.py"])
def test_the_references_import_only_torch(path):
    import ast

    text = (ROOT / path).read_text()
    tree = ast.parse(text)
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert {n.split(".")[0] for n in names} <= {
        "__future__", "math", "contextlib", "typing", "torch"}
    assert "allow_tf32 = False" in text


def test_spans_and_the_positions_counter():
    """With tracing on, a decode step records ``repro.mla.decode`` for
    each latent layer, ``repro.moe.shared`` for each MoE layer and the
    counter ``repro.mla.positions`` = Σ (pos + 1); prefill records
    ``repro.mla.prefill`` for each layer. Off, nothing is recorded."""
    from repro_torch import obs

    cfg, m, p = model_and_params()
    pos = torch.tensor([3, 8], dtype=torch.int32)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    obs.TRACE.clear()
    prev = obs.enable(True)
    try:
        with torch.inference_mode():
            cache = m.init_cache(B, 16, device="cpu")
            _, cache = engine.make_prefill(m, with_cache=True)(
                p, cache, tokens(cfg, s=8))
            m.decode_step(p, cache, tok, pos)
        events = obs.TRACE.events()
    finally:
        obs.enable(prev)
        obs.TRACE.clear()
    names = [e["name"] for e in events if e["ph"] == "X"]
    assert names.count("repro.mla.prefill") == cfg.n_layers
    assert names.count("repro.mla.decode") == cfg.n_layers
    assert names.count("repro.moe.shared") == 2 * (cfg.n_layers - 1)
    counters = [e for e in events if e["ph"] == "C"]
    assert [c["args"]["repro.mla.positions"] for c in counters] == [
        float(4 + 9)]
    with torch.inference_mode():
        m.decode_step(p, cache, tok, pos)
    assert obs.TRACE.events() == []


# ------------------------------------------- the absorbed-attention kernel
def _split(x):
    """x as the kernel feeds it to bfloat16 mmas: hi + lo, each bfloat16."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def kernel_mirror(q_lat, q_pe, c_cache, pe_cache, pos, scale, chunk,
                  parts=_split):
    """``csrc/mla_decode.cu``'s arithmetic in plain float32: each row's keys
    ``[0, pos]`` in chunks of ``chunk``; a chunk's scores from q's parts
    against the bfloat16 cache widened exactly, its max, ``exp(s - max)``,
    their sum and ``Σ p c`` from p's parts; the chunks merged by their
    maxes (flash attention's merge)."""
    qs, pes = parts(q_lat), parts(q_pe)
    out = torch.empty(q_lat.shape)
    for b in range(q_lat.shape[0]):
        n = int(pos[b]) + 1
        ms, ls, os_ = [], [], []
        for lo in range(0, n, chunk):
            c = c_cache[b, lo:min(lo + chunk, n)].float()
            pe = pe_cache[b, lo:min(lo + chunk, n)].float()
            s = scale * (sum(q[b] @ c.T for q in qs)
                         + sum(q[b] @ pe.T for q in pes))
            m = s.max(-1).values
            p = torch.exp(s - m[:, None])
            ms.append(m)
            ls.append(p.sum(-1))
            os_.append(sum(x @ c for x in parts(p)))
        top = torch.stack(ms).max(0).values
        w = [torch.exp(m - top) for m in ms]
        total = sum(lw * wi for lw, wi in zip(ls, w))
        out[b] = sum(o * wi[:, None] for o, wi in zip(os_, w)) / total[:, None]
    return out


def latent_operands(h, s_max, pos, seed=5):
    """The published widths at ``h`` heads: the config, q_nope, q_pe,
    wkv_b, and bfloat16 caches of ``s_max`` slots, every slot filled."""
    cfg = dataclasses.replace(tconfigs.get_config("deepseek-v2-lite"),
                              n_heads=h)
    g = torch.Generator().manual_seed(seed)
    b, r = len(pos), cfg.kv_lora_rank
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    return (cfg, torch.randn(b, h, nope, generator=g),
            torch.randn(b, h, rope, generator=g),
            torch.randn(r, h, nope + dv, generator=g) / math.sqrt(r),
            torch.randn(b, s_max, r, generator=g).bfloat16(),
            torch.randn(b, s_max, rope, generator=g).bfloat16())


@pytest.mark.parametrize("heads", [16, 32])
def test_the_kernels_arithmetic_matches_the_plain_path(heads):
    """The kernel's arithmetic (chunks of its length, q and p split into
    bfloat16 hi and lo, the chunks' merge) gives ``absorbed_attend``'s
    plain path within float32 rounding, at ragged positions: 0, a chunk
    less one, a chunk, and the last slot. q and p rounded to bfloat16
    alone miss it by more than ten times the tolerance."""
    chunk = mla_decode.CHUNK
    s_max = 2 * chunk + 40
    pos = torch.tensor([0, chunk - 1, chunk, s_max - 1], dtype=torch.int32)
    cfg, q_nope, q_pe, wkv_b, c, pe = latent_operands(heads, s_max, pos)
    want = mla.absorbed_attend(q_nope, q_pe, wkv_b, c, pe, pos, cfg)
    nope = cfg.qk_nope_head_dim
    w = wkv_b.transpose(0, 1)
    q_lat = (q_nope.transpose(0, 1) @ w[..., :nope].transpose(1, 2)
             ).transpose(0, 1)

    def err(parts):
        o_lat = kernel_mirror(q_lat, q_pe, c, pe, pos,
                              mla.softmax_scale(cfg), chunk, parts)
        got = (o_lat.transpose(0, 1) @ w[..., nope:]).transpose(0, 1)
        return float((got - want).abs().max() / want.abs().max())

    assert err(_split) <= 1e-5
    assert err(lambda x: [x.bfloat16().float()]) > 1e-4


def _refused():
    """Operands the kernel refuses, each with the words of its error."""
    b, h, s = 2, 16, 64
    ok = dict(q_lat=torch.zeros(b, h, 512), q_pe=torch.zeros(b, h, 64),
              c_cache=torch.zeros(b, s, 512, dtype=torch.bfloat16),
              pe_cache=torch.zeros(b, s, 64, dtype=torch.bfloat16),
              pos=torch.zeros(b, dtype=torch.int32))
    flat = torch.zeros(b * s * 512 + 8, dtype=torch.bfloat16)
    cases = {
        "rank": (dict(c_cache=torch.zeros(b, s, 256, dtype=torch.bfloat16)),
                 "shape"),
        "rope": (dict(pe_cache=torch.zeros(b, s, 32, dtype=torch.bfloat16)),
                 "shape"),
        "heads": (dict(q_lat=torch.zeros(b, 8, 512),
                       q_pe=torch.zeros(b, 8, 64)), "multiple of 16"),
        "cache dtype": (dict(c_cache=torch.zeros(b, s, 512)), "bfloat16"),
        "query dtype": (dict(q_lat=torch.zeros(b, h, 512,
                                               dtype=torch.bfloat16)),
                        "float32"),
        "pos dtype": (dict(pos=torch.zeros(b, dtype=torch.int64)), "int32"),
        "pos rows": (dict(pos=torch.zeros(b + 1, dtype=torch.int32)),
                     "pos"),
        "last stride": (dict(c_cache=torch.zeros(
            b, 512, s, dtype=torch.bfloat16).transpose(1, 2)), "contiguous"),
        "row stride": (dict(c_cache=torch.zeros(
            b, s, 516, dtype=torch.bfloat16)[..., :512]), "aligned"),
        "first element": (dict(c_cache=flat[1:1 + b * s * 512].view(
            b, s, 512)), "aligned"),
        "cache rows": (dict(pe_cache=torch.zeros(b, s + 1, 64,
                                                 dtype=torch.bfloat16)),
                       "shape"),
    }
    return ok, cases


@pytest.mark.parametrize("case", sorted(_refused()[1]))
def test_the_kernel_wrapper_refuses_what_it_does_not_take(case):
    ok, cases = _refused()
    change, words = cases[case]
    with pytest.raises(ValueError, match=words):
        mla_decode.check_operands(**{**ok, **change})


def test_the_kernel_wrapper_takes_a_layers_slice_and_needs_the_card():
    """A layer's slice of a stacked cache passes the checks by its
    strides; CPU operands are refused for their device, before any
    build."""
    ok, _ = _refused()
    stacked = torch.zeros(3, 2, 64, 512, dtype=torch.bfloat16)
    pe = torch.zeros(3, 2, 64, 64, dtype=torch.bfloat16)
    got = mla_decode.check_operands(ok["q_lat"], ok["q_pe"], stacked[1],
                                    pe[1], ok["pos"])
    assert got == (2, 16, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        mla_decode.mla_attend(**ok, scale=0.1)


def test_the_launch_counter_on_the_cpus_eager_step():
    """``make_decode_step(graph=True)`` on the CPU runs the step eagerly,
    launches no kernel and says so: the counter
    ``repro.mla.attend_launches`` reads 0 beside ``repro.mla.positions``.
    Under a profiler, with tracing off, both are profiler marks
    (``counter:<name>=<value>``), which the benchmark reads."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    cfg, m, p = model_and_params()
    pos = torch.tensor([3, 8], dtype=torch.int32)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    step = engine.make_decode_step(m, graph=True)
    before = mla_decode.launches["mla_attend"]
    with torch.inference_mode():
        cache = m.init_cache(B, 16, device="cpu")
        obs.TRACE.clear()
        prev = obs.enable(True)
        try:
            step(p, cache, tok, pos)
            events = obs.TRACE.events()
        finally:
            obs.enable(prev)
            obs.TRACE.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(p, cache, tok, pos)
    counters = {k: v for e in events if e["ph"] == "C"
                for k, v in e["args"].items()}
    assert counters == {"repro.mla.positions": 13.0,
                        "repro.mla.attend_launches": 0.0}
    marks = [e.name for e in prof.events()
             if e.name.startswith(obs.trace.COUNTER_MARK)]
    assert marks == ["counter:repro.mla.positions=13.0",
                     "counter:repro.mla.attend_launches=0.0"]
    assert mla_decode.launches["mla_attend"] == before
    assert obs.TRACE.events() == []


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _long_chat():
    mix = json.loads((ROOT / "portbench" / "traffic" / "long_chat.json")
                     .read_text())
    return mix["positions"], mix["s_max"]


@pytest.mark.card
def test_the_kernel_matches_the_plain_path_on_the_card(card):
    """At the long-chat cell's shapes (24 rows, 16384 slots, its
    contexts): ``absorbed_attend`` through the kernel against the plain
    path on the card, eagerly, then in a captured graph replayed with two
    other position vectors, within 1e-4 of the largest value."""
    positions, s_max = _long_chat()
    pos0 = torch.tensor(positions, dtype=torch.int32, device=card)
    cfg, *ops = latent_operands(16, s_max, positions)
    q_nope, q_pe, wkv_b, c, pe = (t.to(card) for t in ops)
    q_nope, q_pe, wkv_b = (t.bfloat16() for t in (q_nope, q_pe, wkv_b))
    nope, scale = cfg.qk_nope_head_dim, mla.softmax_scale(cfg)

    def plain(pos):
        w = wkv_b.float().transpose(0, 1)
        q_lat = torch.matmul(q_nope.float().transpose(0, 1),
                             w[..., :nope].transpose(1, 2)).transpose(0, 1)
        o_lat = mla.latent_attend_plain(q_lat, q_pe, c, pe, pos, scale)
        return torch.matmul(o_lat.transpose(0, 1),
                            w[..., nope:]).transpose(0, 1)

    def attend(pos):
        return mla.absorbed_attend(q_nope, q_pe, wkv_b, c, pe, pos, cfg)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    with torch.inference_mode():
        before = mla_decode.launches["mla_attend"]
        assert rel(attend(pos0), plain(pos0)) <= 1e-4
        assert mla_decode.launches["mla_attend"] == before + 1
        held = pos0.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = attend(held)
        chunk = mla_decode.CHUNK
        edges = torch.tensor([0, chunk - 1, chunk, s_max - 1],
                             dtype=torch.int32, device=card)
        for pos in (pos0 + 64, torch.cat([edges, pos0.flip(0)[4:]])):
            held.copy_(pos)
            graph.replay()
            assert rel(out, plain(pos)) <= 1e-4
        assert mla_decode.launches["mla_attend"] == before + 2


@pytest.mark.card
def test_the_captured_step_holds_the_kernel_on_the_card(card):
    """The published widths at two layers (the dense one and one MoE
    layer), a prompt past a chunk: the captured step repeats the eager
    functional step bit for bit, holds one kernel launch a layer and says
    so on every replay (``repro.mla.attend_launches``)."""
    from repro_torch import obs

    cfg = dataclasses.replace(tconfigs.get_config("deepseek-v2-lite"),
                              n_layers=2)
    m = build(cfg)
    p = m.init(torch.Generator(device="cuda").manual_seed(3), "cuda")
    prompt = mla_decode.CHUNK + 8
    tok = torch.randint(0, cfg.vocab_size, (4, prompt + 6), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(4))
    pre = engine.make_prefill(m, with_cache=True)
    step = engine.make_decode_step(m)
    graphed = engine.make_decode_step(m, graph=True)
    with torch.inference_mode():
        _, want = pre(p, m.init_cache(4, prompt + 64, device="cuda"),
                      tok[:, :prompt])
        _, cache = pre(p, m.init_cache(4, prompt + 64, device="cuda"),
                       tok[:, :prompt])
        obs.TRACE.clear()
        prev = obs.enable(True)
        try:
            for i in range(prompt, prompt + 6):
                pos = torch.arange(4, dtype=torch.int32, device="cuda") + i
                lg_want, want = step(p, want, tok[:, i:i + 1], pos)
                lg, cache = graphed(p, cache, tok[:, i:i + 1], pos)
                assert torch.equal(lg, lg_want)
            events = obs.TRACE.events()
        finally:
            obs.enable(prev)
            obs.TRACE.clear()
    assert graphed.attend_launches == cfg.n_layers
    assert [e["args"]["repro.mla.attend_launches"] for e in events
            if e["name"] == "repro.mla.attend_launches"] == [2.0] * 6
    for a, b in zip(tree_leaves(cache), tree_leaves(want)):
        assert torch.equal(a, b)
