"""The port's enc-dec path (whisper-base, reduced) against the JAX
package's: the same params (JAX's, carried across with
``params_from_numpy``), frames and tokens give the same encoder output and
``forward`` logits, the same cross caches from ``prefill_encdec_cache``,
and the same logits from the decode steps after it, which also match the
port's own ``forward`` (``tests/test_serve.py``'s enc-dec tolerance,
3e-3). ``greedy_generate`` takes JAX's token-by-token path with empty
cross caches and gives JAX's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import build as jbuild
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tL
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine

ARCH = "whisper-base"
B, S, ENC = 2, 12, 8
TOL = 3e-3


def pair(seed=4):
    """(JAX model, its params, port model, the same params on the CPU)."""
    jm = jbuild(jconfigs.get_reduced(ARCH))
    tm = tbuild(tconfigs.get_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         tm.cfg, device="cpu")


def inputs(cfg, seed=6):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, toks


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_encode_and_forward_match_jax():
    jm, jp, tm, tp = pair()
    frames, toks = inputs(jm.cfg)
    want = jax.jit(lambda p, f: jT.encode(p, f, jm.cfg, None))(
        jp, jnp.asarray(frames))
    got = tT.encode(tp, torch.from_numpy(frames), tm.cfg)
    assert got.shape == (B, ENC, tm.cfg.d_model)
    close(got, want)
    want, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)})
    got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                                "frames": torch.from_numpy(frames)})
    assert got.shape == want.shape == (B, S, tm.padded_vocab)
    close(got, want)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_encdec_cache_and_decode_match_jax_and_forward():
    """The cross caches equal JAX's; each decode step after them equals
    JAX's step and the port's own ``forward``; the cache given is left as
    it was."""
    jm, jp, tm, tp = pair()
    frames, toks = inputs(jm.cfg)
    jc = jengine.prefill_encdec_cache(jm, jp, jnp.asarray(frames),
                                      jm.init_cache(B, S, enc_len=ENC))
    tc0 = tm.init_cache(B, S, enc_len=ENC, device="cpu")
    tc = tengine.prefill_encdec_cache(tm, tp, torch.from_numpy(frames), tc0)
    for slot in jc["blocks"]:
        for name in ("ck", "cv"):
            assert tc["blocks"][slot][name].shape == \
                jc["blocks"][slot][name].shape
            close(tc["blocks"][slot][name], jc["blocks"][slot][name], 1e-5)
    assert not tc0["blocks"]["s0"]["ck"].any()
    full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                              "frames": torch.from_numpy(frames)})
    jstep = jax.jit(jengine.make_decode_step(jm, None))
    tstep = tengine.make_decode_step(tm)
    for i in range(S):
        want, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                         jnp.full((B,), i, jnp.int32))
        got, tc = tstep(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                        torch.full((B,), i, dtype=torch.int32))
        close(got, want)
        close(got, full[:, i:i + 1])
    close(tc["blocks"]["s0"]["k"], jc["blocks"]["s0"]["k"])


def test_prefill_with_cache_rejects_encdec_as_jax_does():
    jm, jp, tm, tp = pair(16)
    jc, tc = jm.init_cache(B, S, enc_len=4), tm.init_cache(
        B, S, enc_len=4, device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        jengine.make_prefill(jm, None, with_cache=True)(
            jp, jc, jnp.zeros((B, S), jnp.int32))
    with pytest.raises(NotImplementedError, match="prefill_encdec_cache") \
            as terr:
        tengine.make_prefill(tm, None, with_cache=True)(
            tp, tc, torch.zeros((B, S), dtype=torch.int32))
    assert str(terr.value) == str(jerr.value)


def test_greedy_generate_falls_back_to_the_reference_as_jax_does():
    """JAX's enc-dec ``greedy_generate`` decodes token by token with empty
    cross caches and ignores ``enc_batch``: the port gives its tokens."""
    jm, jp, tm, tp = pair(17)
    pr = np.random.default_rng(18).integers(
        0, jm.cfg.vocab_size, (1, 3)).astype(np.int32)
    frames, _ = inputs(jm.cfg, seed=19)
    want = jengine.greedy_generate(jm, jp, jnp.asarray(pr), n_steps=3,
                                   s_max=8)
    got = tengine.greedy_generate(
        tm, tp, torch.from_numpy(pr), n_steps=3, s_max=8,
        enc_batch={"frames": torch.from_numpy(frames)}, device="cpu")
    assert got.shape == (1, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tengine.greedy_generate_reference(
        tm, tp, torch.from_numpy(pr), n_steps=3, s_max=8, device="cpu"))


def test_cross_attention_over_an_empty_cache_gives_zeros():
    jm, jp, tm, tp = pair()
    x = np.random.default_rng(20).standard_normal(
        (B, 1, jm.cfg.d_model)).astype(np.float32)
    shape = (B, 0, jm.cfg.n_kv_heads, jm.cfg.d_head)
    jp_c = jax.tree.map(lambda a: a[0], jp["blocks"]["s0"]["cross"])
    want, _, _ = jL.decode_attention(
        jp_c, jnp.asarray(x), jnp.zeros(shape), jnp.zeros(shape),
        jnp.zeros((B,), jnp.int32), jm.cfg, None, cross=True)
    tp_c = tT._index(tp["blocks"]["s0"]["cross"], 0)
    got, k2, _ = tL.decode_attention(
        tp_c, torch.from_numpy(x), torch.zeros(shape), torch.zeros(shape),
        torch.zeros((B,), dtype=torch.int32), tm.cfg, cross=True)
    assert not np.asarray(want).any()
    assert got.shape == (B, 1, tm.cfg.d_model) and k2.shape == shape
    assert torch.isfinite(got).all() and not got.any()


def test_params_layout_and_batch_shapes_match_jax():
    """``params_from_numpy`` checks the encoder subtree against the config;
    ``concrete_batch`` gives JAX's names, shapes and dtypes, frames
    included."""
    from repro.models.config import ShapeSpec as JShape
    from repro_torch.models.config import ShapeSpec as TShape

    jm, jp, tm, _ = pair()
    tree = jax.tree.map(np.asarray, jp)
    cut = dict(tree, encoder=dict(tree["encoder"], blocks=jax.tree.map(
        lambda a: a[:1], tree["encoder"]["blocks"])))
    with pytest.raises(ValueError, match="encoder's layout"):
        params_from_numpy(cut, tm.cfg, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        params_from_numpy({k: v for k, v in tree.items() if k != "encoder"},
                          tm.cfg, device="cpu")
    shape = dataclasses.astuple(JShape("smoke", 32, 2, "train"))
    got = tm.concrete_batch(TShape(*shape), device="cpu")
    want = jm.concrete_batch(JShape(*shape))
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for name, v in want.items():
        assert tuple(got[name].shape) == v.shape
        assert str(got[name].dtype) == f"torch.{v.dtype}"
