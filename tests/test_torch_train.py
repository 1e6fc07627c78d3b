"""One train step of the port (``repro_torch.train.make_train_step``)
against the JAX package's from the same state (JAX's initial one, carried
across with ``train_state_from_numpy``) on the same numpy batch, for seven
archs: the loss and every metric, and Adam's first moments, which are
linear in the grads (post-Adam params are not compared: at step 1
``m/sqrt(v)`` is sign(g), which turns reduction-order noise into O(lr)
differences, ``tests/test_substrate.py:180-182``).

Tolerances are the forward parity ones of ``ROADMAP.md``: the attention
families' float32 grads within 2e-4 (``tests/test_flash.py:66``), MoE, SSD
and RG-LRU within 5e-3; each first moment within that fraction of its
largest magnitude, the metrics within rtol 1e-5 for the attention families
and the tolerance for the others. Also: ``remat="block"`` gives the bits of
``"none"``, the compressor runs inside the step, and the training entry
points need the card unless asked for the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.optim as jopt
import repro.train as jtrain
import repro_torch.configs as tconfigs
import repro_torch.optim as topt
import repro_torch.train as ttrain
from repro.models import build as jbuild
from repro.train.step import init_train_state as jinit_train_state
from repro_torch.common.pytree import tree_leaves_with_path, tree_map
from repro_torch.models import build as tbuild

B, S = 2, 16

#: (arch, config overrides, tolerance). olmoe takes capacity_factor=16 as
#: tests/test_serve.py does (no token dropped); gemma3's chunk of 4 walks
#: four flash chunks with its window of 16; internvl2 has a frontend prefix
#: that the loss slices off; whisper trains its encoder through cross
#: attention.
ARCHS = [
    ("qwen1.5-0.5b", {}, 2e-4),                      # dense, tied, qkv bias
    ("olmoe-1b-7b", {"capacity_factor": 16.0}, 5e-3),  # MoE aux loss
    ("internvl2-1b", {}, 2e-4),                      # VLM prefix slice
    ("gemma3-1b", {"attn_chunk": 4}, 2e-4),          # local window
    ("mamba2-370m", {}, 5e-3),                       # SSD
    ("recurrentgemma-2b", {}, 5e-3),                 # RG-LRU
    ("whisper-base", {}, 2e-4),                      # enc-dec
]
IDS = [a for a, _, _ in ARCHS]


def configs(arch, **more):
    _, kw, _ = ARCHS[IDS.index(arch)]
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw, **more),
            dataclasses.replace(tconfigs.get_reduced(arch), **kw, **more))


def tcfgs(compress="none"):
    opt = dict(warmup_steps=0, mixed_precision=False)
    return (jtrain.TrainConfig(optimizer=jopt.AdamWConfig(**opt),
                               compressor=jopt.Compressor(compress),
                               xent_chunk=8),
            ttrain.TrainConfig(optimizer=topt.AdamWConfig(**opt),
                               compressor=topt.Compressor(compress),
                               xent_chunk=8))


def batch_for(cfg, seed=5):
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, 12, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "vision_stub":
        out["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jax_state(arch):
    jcfg, _ = configs(arch)
    jt, _ = tcfgs()
    return jinit_train_state(jbuild(jcfg), jt, jax.random.PRNGKey(0))


def port_state(arch, tcfg):
    return ttrain.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_state(arch)), tcfg, device="cpu")


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", IDS)
def test_train_step_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    jt, tt = tcfgs()
    tol = ARCHS[IDS.index(arch)][2]
    batch = batch_for(tcfg)
    js, jm = jax.jit(jtrain.make_train_step(jbuild(jcfg), None, jt))(
        jax_state(arch), {k: jnp.asarray(v) for k, v in batch.items()})
    state = port_state(arch, tcfg)
    ts, tm = ttrain.make_train_step(tbuild(tcfg), None, tt)(state,
                                                             tbatch(batch))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=1e-5 if tol < 1e-3 else tol,
                                   atol=1e-7, err_msg=k)
    assert float(tm["tokens"]) == B * S
    if tcfg.family == "moe":
        assert float(tm["aux"]) > 0
    jl = jax.tree_util.tree_flatten_with_path(js["opt"]["m"])[0]
    tl = tree_leaves_with_path(ts["opt"]["m"])
    assert len(jl) == len(tl)
    for (p, a), (_, b) in zip(jl, tl):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.numpy(), a, rtol=tol,
                                   atol=tol * np.abs(a).max(),
                                   err_msg=jax.tree_util.keystr(p))
    assert int(ts["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b",
                                  "whisper-base"])
def test_remat_block_gives_the_bits_of_none(arch):
    """On the CPU the recompute of each period (and the encoder's) repeats
    the forward's bits, so a step under ``remat="block"`` equals one under
    ``"none"`` bit for bit, and so does ``"block_save"``, which takes the
    named ``attn_out`` outputs from memory instead of recomputing them."""
    _, tblock = configs(arch, remat="block")
    _, tnone = configs(arch, remat="none")
    _, tt = tcfgs()
    batch = tbatch(batch_for(tblock))
    s1, m1 = ttrain.make_train_step(tbuild(tblock), None, tt)(
        port_state(arch, tblock), batch)
    s2, m2 = ttrain.make_train_step(tbuild(tnone), None, tt)(
        port_state(arch, tnone), batch)
    assert {k: float(v) for k, v in m1.items()} == {
        k: float(v) for k, v in m2.items()}
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             s1, s2)
    _, tsave = configs(arch, remat="block_save")
    s3, m3 = ttrain.make_train_step(tbuild(tsave), None, tt)(
        port_state(arch, tsave), batch)
    assert {k: float(v) for k, v in m3.items()} == {
        k: float(v) for k, v in m1.items()}
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             s3, s1)


def test_int8_compression_inside_the_step_matches_jax():
    """``Compressor("int8")`` inside the step: the same loss as JAX's and
    the same error residual, but where an entry of the quantised grads
    rounds the other way (grads within 1e-6 of each other, a few entries
    in 10^5 lie that close to a rounding boundary), which moves that
    entry by one quantum."""
    arch = "qwen1.5-0.5b"
    jcfg, tcfg = configs(arch)
    jt, tt = tcfgs("int8")
    batch = batch_for(tcfg)
    js = jinit_train_state(jbuild(jcfg), jt, jax.random.PRNGKey(0))
    js2, jm = jax.jit(jtrain.make_train_step(jbuild(jcfg), None, jt))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ttrain.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                          tcfg, device="cpu")
    assert tree_leaves_with_path(state["error"])
    ts2, tm = ttrain.make_train_step(tbuild(tcfg), None, tt)(state,
                                                              tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    total = flipped = 0
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(js2["error"])[0],
            tree_leaves_with_path(ts2["error"])):
        a, b = np.asarray(a), b.numpy()
        half = np.abs(a).max()           # about half a quantum
        diff = np.abs(a - b)
        assert diff.max() <= 2.05 * half
        total += a.size
        flipped += int((diff > 1e-3 * half).sum())
    assert flipped <= total * 1e-4, (flipped, total)
    assert bool((ts2["error"]["embed"]["tok"] != 0).any())


def test_train_entry_points_need_the_card_unless_asked(tmp_path):
    from repro_torch.checkpoint import restore, save

    model = tbuild(tconfigs.get_reduced("qwen1.5-0.5b"))
    _, tt = tcfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.init_train_state(model, tt)
    state = ttrain.init_train_state(model, tt, device="cpu")
    assert state["params"]["embed"]["tok"].device == torch.device("cpu")
    assert state["error"] == {}
    host = jax.tree.map(np.asarray, jax_state("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_state_from_numpy(host, model.cfg)
    save(str(tmp_path), state, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), state)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(model, None, tt, grad_pspecs={})
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(model, None,
                               dataclasses.replace(tt, pod_axis="pod"))
