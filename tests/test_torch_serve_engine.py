"""The port's LM serving engine (``repro_torch.serve.engine``) against the
JAX package's: greedy generation from the same params and prompt gives the
same tokens, and the single-pass prefill gives the tokens of the
token-by-token loop (``tests/test_serve.py``'s shapes: prompt (2, 5), 6
steps, ``s_max=16``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
import repro_torch.serve as tserve
from repro.models import build as jbuild
from repro.serve import engine as jengine
from repro_torch.models import build as tbuild
from repro_torch.models import params_from_numpy
from repro_torch.serve import engine as tengine


def pair(arch, seed=12):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def prompt(cfg, shape=(2, 5), seed=13):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "qwen2.5-3b",
                                  "mamba2-370m", "recurrentgemma-2b"])
def test_greedy_generate_tokens_equal_jax(arch):
    jm, jp, tm, tp = pair(arch)
    pr = prompt(jm.cfg)
    want = jengine.greedy_generate(jm, jp, jnp.asarray(pr), n_steps=6,
                                   s_max=16)
    got = tengine.greedy_generate(tm, tp, torch.from_numpy(pr), n_steps=6,
                                  s_max=16, device="cpu")
    assert got.shape == (2, 11) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :5].numpy(), pr)
    assert int(got.max()) < tm.cfg.vocab_size


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "qwen2.5-3b",
                                  "llama3.2-3b", "qwen1.5-0.5b",
                                  "internvl2-1b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_greedy_generate_prefill_matches_token_by_token(arch):
    """``tests/test_serve.py``'s
    ``test_greedy_generate_prefill_matches_token_by_token`` in the port."""
    _, _, tm, tp = pair(arch)
    pr = torch.from_numpy(prompt(tm.cfg))
    new = tengine.greedy_generate(tm, tp, pr, n_steps=6, s_max=16,
                                  device="cpu")
    old = tengine.greedy_generate_reference(tm, tp, pr, n_steps=6, s_max=16,
                                            device="cpu")
    assert torch.equal(new, old)


def test_make_prefill_last_position_matches_jax():
    """``make_prefill`` without a cache: the last position's logits and the
    aux loss of a forward."""
    jm, jp, tm, tp = pair("olmoe-1b-7b")
    toks = prompt(jm.cfg, (2, 8), seed=14)
    want, jaux = jengine.make_prefill(jm, None)(jp, {"tokens":
                                                     jnp.asarray(toks)})
    got, taux = tengine.make_prefill(tm, None)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tm.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_greedy_generate_edges():
    _, _, tm, tp = pair("qwen1.5-0.5b")
    pr = torch.from_numpy(prompt(tm.cfg, (1, 4)))
    assert torch.equal(tengine.greedy_generate(tm, tp, pr, n_steps=0,
                                               s_max=8, device="cpu"), pr)
    with pytest.raises(ValueError, match="outside the cache"):
        tengine.greedy_generate(tm, tp, pr, n_steps=6, s_max=8,
                                device="cpu")
    with pytest.raises(ValueError, match="params lie on"):
        tengine.greedy_generate(tm, tp, pr, n_steps=2, s_max=8,
                                device="meta")


def test_greedy_generate_signature_matches_jax():
    """JAX's parameters in JAX's order up to ``enc_batch``, so a call
    written for ``repro`` binds the same parameters by keyword or by
    position; the port's ``device`` comes after them."""
    import inspect

    jparams = list(inspect.signature(jengine.greedy_generate).parameters)
    tparams = list(inspect.signature(tengine.greedy_generate).parameters)
    assert jparams[-1] == "enc_batch"
    assert tparams == jparams + ["device"]
    _, _, tm, tp = pair("qwen1.5-0.5b")
    pr = torch.from_numpy(prompt(tm.cfg, (1, 4)))
    by_position = tengine.greedy_generate(tm, tp, pr, 2, 8, None, None,
                                          "cpu")
    assert torch.equal(by_position, tengine.greedy_generate(
        tm, tp, pr, n_steps=2, s_max=8, enc_batch=None, device="cpu"))


def test_serve_package_re_exports_the_engine():
    assert dataclasses.asdict(tengine.ServeConfig()) == dataclasses.asdict(
        jengine.ServeConfig())
    for name in ("ServeConfig", "greedy_generate", "make_decode_step",
                 "make_prefill"):
        assert getattr(tserve, name) is getattr(tengine, name)
        assert name in tserve.__all__
