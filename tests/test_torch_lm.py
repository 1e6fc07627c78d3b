"""The port's LM zoo (``repro_torch.models``) against the JAX package's on
the decoder-only families: the same params (JAX's initial ones, carried
across with ``params_from_numpy``) and the same numpy tokens give the same
``forward`` logits and MoE aux loss, the same ``decode_step`` logits step
by step, and the same ``prefill_with_cache`` logits and cache (every leaf:
K/V, and the SSD and RG-LRU states ``h`` and ``conv``), at
``tests/test_serve.py``'s tolerances (2e-3 for attention, 5e-3 for SSD,
RG-LRU and MoE). Enc-dec (whisper) is ``tests/test_torch_encdec.py``'s."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import build as jbuild
from repro.serve.engine import make_decode_step as jmake_decode_step
from repro.serve.engine import make_prefill as jmake_prefill
from repro_torch.common.pytree import tree_map
from repro_torch.models import build as tbuild
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as tT

B, S = 2, 20

#: (arch, config overrides, tolerance). gemma3 reduced has a window of 16
#: and S = 20 > 16, so its local layers mask; its chunk of 4 makes the
#: flash forward walk five chunks. olmoe takes capacity_factor=16 as
#: tests/test_serve.py does, so prefill drops no token. mamba2 reduced has
#: an SSD chunk of 16, so S = 20 takes the gcd chunking (five chunks of
#: 4); recurrentgemma reduced (rec, rec, local, then a rec tail) has a
#: window of 16 too.
ARCHS = [
    ("qwen2.5-3b", {}, 2e-3),                    # GQA + qkv bias
    ("llama3.2-3b", {}, 2e-3),                   # GQA
    ("gemma3-1b", {"attn_chunk": 4}, 2e-3),      # local/global, GELU
    ("qwen1.5-0.5b", {}, 2e-3),                  # tied embeddings
    ("internvl2-1b", {}, 2e-3),                  # vision stub
    ("olmoe-1b-7b", {"capacity_factor": 16.0}, 5e-3),   # MoE
    ("mamba2-370m", {}, 5e-3),                   # SSD chunked vs recurrent
    ("recurrentgemma-2b", {}, 5e-3),             # RG-LRU scan vs sequential
]
IDS = [a for a, _, _ in ARCHS]


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX model, its params, port model, the same params on the CPU)."""
    _, kw, _ = ARCHS[IDS.index(arch)]
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def tol(arch):
    return ARCHS[IDS.index(arch)][2]


def tokens(cfg, seed=5, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def close(got, want, t):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want,
                                                                   np.float32),
                               rtol=t, atol=t)


def node(tree, path):
    """The port tree's node at a JAX key path (dict keys, list indices)."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def close_tree(got, want, t):
    """Every leaf of the port tree ``got`` against JAX's ``want``: the same
    paths, shapes and dtypes, values within ``t``."""
    leaves = jax.tree.flatten_with_path(want)[0]
    n = []
    tree_map(n.append, got)
    assert len(n) == len(leaves)
    for path, v in leaves:
        g = node(got, path)
        assert tuple(g.shape) == v.shape, jax.tree_util.keystr(path)
        assert str(g.dtype) == f"torch.{v.dtype}", jax.tree_util.keystr(path)
        close(g, v, t)


def test_params_carried_across_keep_nesting_and_dtypes():
    jm, jp, tm, tp = pair("gemma3-1b")
    jleaves, jdef = jax.tree.flatten_with_path(jp)
    flat = {jax.tree_util.keystr(p): v for p, v in jleaves}
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == 1
    assert set(tp["blocks"]) == {f"s{i}" for i in range(6)}
    n = 0
    for path, v in flat.items():
        node = tp
        for key in path.strip("[]").split("]["):
            node = node[int(key) if key.isdigit() else key.strip("'")]
        assert tuple(node.shape) == v.shape, path
        assert str(node.dtype).replace("torch.", "") == str(v.dtype), path
        np.testing.assert_array_equal(node.numpy(), np.asarray(v))
        n += 1
    assert n == len(jleaves)
    with pytest.raises(ValueError, match="layout"):
        params_from_numpy(jax.tree.map(np.asarray, jp),
                          tconfigs.get_reduced("llama3.2-3b"), device="cpu")


def test_bfloat16_params_carried_across():
    cfg = dataclasses.replace(jconfigs.get_reduced("llama3.2-3b"),
                              dtype="bfloat16")
    jp = jbuild(cfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.get_reduced("llama3.2-3b"),
                               dtype="bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    w = tp["blocks"]["s0"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16 == tcfg.param_dtype
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jp["blocks"]["s0"]["attn"]["wq"], np.float32))


@pytest.mark.parametrize("arch", IDS)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = pair(arch)
    toks = tokens(jm.cfg)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jm.cfg.frontend == "vision_stub":
        fr = np.random.default_rng(6).standard_normal(
            (B, jm.cfg.n_frontend_tokens, jm.cfg.d_model)).astype(np.float32)
        jb["frontend"], tb["frontend"] = jnp.asarray(fr), torch.from_numpy(fr)
    want, jaux = jax.jit(jm.forward)(jp, jb)
    got, taux = tm.forward(tp, tb)
    assert got.shape == want.shape == (B, S + jm.cfg.n_frontend_tokens,
                                       tm.padded_vocab)
    close(got, want, tol(arch))
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    if jm.cfg.family == "moe":
        assert float(taux) > 0
    hidden, _ = tT.forward(tp, tb, tm.cfg, return_hidden=True)
    assert hidden.shape == (B, got.shape[1], tm.cfg.d_model)


@pytest.mark.parametrize("arch", IDS)
def test_decode_steps_match_jax(arch):
    """Every position fed through ``decode_step``: each step's logits and
    the final cache equal JAX's."""
    jm, jp, tm, tp = pair(arch)
    toks = tokens(jm.cfg, seed=7)
    jstep = jax.jit(jmake_decode_step(jm, None))
    jc = jm.init_cache(B, S)
    tc = tm.init_cache(B, S, device="cpu")
    for i in range(S):
        jpos = jnp.full((B,), i, jnp.int32)
        tpos = torch.full((B,), i, dtype=torch.int32)
        want, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jpos)
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                 tpos)
        assert got.shape == (B, 1, tm.padded_vocab)
        close(got, want, tol(arch))
    close_tree(tc, jc, tol(arch))


@pytest.mark.parametrize("arch", IDS)
def test_prefill_with_cache_matches_jax(arch):
    """The last position's logits and the filled cache, slot by slot,
    equal JAX's; the cache given is left as it was; one more decode step
    from the prefilled cache matches JAX's too."""
    jm, jp, tm, tp = pair(arch)
    toks = tokens(jm.cfg, seed=9)
    s_max = S + 4
    jc = jm.init_cache(B, s_max)
    tc = tm.init_cache(B, s_max, device="cpu")
    want, jc2 = jax.jit(jmake_prefill(jm, None, with_cache=True))(
        jp, jc, jnp.asarray(toks))
    got, tc2 = tT.prefill_with_cache(tp, tc, torch.from_numpy(toks), tm.cfg)
    assert got.shape == (B, 1, tm.padded_vocab)
    close(got, want, tol(arch))
    close_tree(tc2, jc2, tol(arch))
    given = []
    tree_map(given.append, tc)
    assert not any(t.any() for t in given)
    nxt = np.full((B, 1), 3, np.int32)
    want, _ = jax.jit(jmake_decode_step(jm, None))(
        jp, jc2, jnp.asarray(nxt), jnp.full((B,), S, jnp.int32))
    got, _ = tm.decode_step(tp, tc2, torch.from_numpy(nxt),
                            torch.full((B,), S, dtype=torch.int32))
    close(got, want, tol(arch))


def test_decode_step_rejects_a_position_past_the_cache():
    """JAX's dynamic-update-slice clamps ``pos`` silently; the port
    raises."""
    _, _, tm, tp = pair("llama3.2-3b")
    tc = tm.init_cache(B, 4, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the cache"):
        tm.decode_step(tp, tc, tok, torch.full((B,), 4, dtype=torch.int32))


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_every_arch_builds_with_jax_tree_and_dtypes(arch):
    """``build`` and ``init_params`` take all ten archs (reduced) and give
    JAX's params tree: the same paths, shapes and dtypes."""
    tcfg = tconfigs.get_reduced(arch)
    tm = tbuild(tcfg)
    tp = tT.init_params(tcfg, torch.Generator().manual_seed(0))
    want = jbuild(jconfigs.get_reduced(arch)).abstract_params()
    leaves = jax.tree.flatten_with_path(want)[0]
    n = []
    tree_map(n.append, tp)
    assert len(n) == len(leaves)
    for path, v in leaves:
        g = node(tp, path)
        assert tuple(g.shape) == v.shape, jax.tree_util.keystr(path)
        assert str(g.dtype) == f"torch.{v.dtype}", jax.tree_util.keystr(path)
    assert tm.padded_vocab == tp["embed"]["tok"].shape[0]


def test_sharding_axes_raise():
    """Sharding axes run a model on DTensors of a mesh: with plain tensors
    and no ambient mesh there is none to run on."""
    from repro_torch.models.layers import Axes

    _, _, tm, tp = pair("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="no ambient mesh"):
        tm.forward(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   axes=Axes())


def test_init_and_concrete_batch_are_seeded():
    from repro_torch.models.config import ShapeSpec

    tm = tbuild(tconfigs.get_reduced("internvl2-1b"))
    a = tm.init(torch.Generator().manual_seed(1), device="cpu")
    b = tm.init(torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a["blocks"]["s0"]["ffn"]["wi"],
                       b["blocks"]["s0"]["ffn"]["wi"])
    assert a["blocks"]["s0"]["ffn"]["wi"].shape == (
        2, tm.cfg.d_model, tm.cfg.d_ff)
    shape = ShapeSpec("smoke", 32, 2, "train")
    batch = tm.concrete_batch(shape, device="cpu")
    assert sorted(batch) == ["frontend", "labels", "tokens"]
    assert batch["tokens"].shape == (2, 32 - tm.cfg.n_frontend_tokens)
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < tm.cfg.vocab_size
    assert torch.equal(batch["frontend"],
                       tm.concrete_batch(shape, device="cpu")["frontend"])
    jm = jbuild(jconfigs.get_reduced("internvl2-1b"))
    jshapes = jm.batch_shapes(shape)
    for name, (shp, dtype) in tm.batch_shapes(shape).items():
        assert shp == jshapes[name].shape
        assert str(dtype).replace("torch.", "") == str(jshapes[name].dtype)
