"""The port on a mesh of 8 gloo ranks against the JAX package on one
device (``tests/test_sharded.py``'s scenarios, where JAX runs on 8 host
devices): one ``torchrun`` of 8 CPU ranks runs every scenario of
``tests/_torch_mesh_ranks.py`` on inputs this test makes with JAX.

* qwen2.5-3b reduced, the (2, 4) ``data×model`` step with ``grad_pspecs``
  against JAX's single-device step from the same state: loss ``rel=1e-3``,
  params within ``5e-3`` (``test_sharded.py``'s bounds; JAX's own sharded
  step is a known failure, so it is no oracle); against the port's
  unsharded step: loss ``rtol=1e-5``, Adam's first moments (linear in the
  grads) within 1e-5 of their largest magnitude.
* gemma3-1b reduced (2 heads on a model axis of 4: the sequence-sharded
  attention) under ``remat="block_save"``, the same against the port's
  unsharded step.
* ``uw``'s weight gradient leaves as one reduce-scatter, no all-reduce
  (``CommDebugMode``).
* gemma3-1b reduced, context-parallel decode on (8,) with
  ``cache_pspecs(seq_shard=True)`` against JAX's plain ``decode_step``
  within 2e-3 (``test_sharded.py``'s bound), the new cache too, three
  all-reduces a layer.
* the same step on (2, 2, 2) ``pod×data×model`` with
  ``TrainConfig(pod_axis="pod")``, against the port's unsharded step.
* qwen1.5-0.5b reduced: JAX's params landed sharded on (2, 4) by
  ``params_from_numpy(..., shardings=)``, saved, and restored onto (4, 2),
  exactly, with at least 2 shards; a checkpoint ``repro`` wrote restored
  onto (4, 2) exactly.
* the MoE, SSD and RG-LRU archs reduced (olmoe-1b-7b, dbrx-132b,
  mamba2-370m, recurrentgemma-2b), the (2, 4) step against JAX's
  single-device step and the port's unsharded step, at qwen's bounds;
  olmoe also under ``remat="block_save"``, its aux loss within 1e-6 of the
  unsharded one; one olmoe MoE FFN's collectives by mesh axis (the expert
  weights all-gathered over ``data`` and their grads reduce-scattered
  back, the expert outputs all-gathered over ``model``); the same archs'
  decode with ``cache_pspecs`` caches against JAX's plain ``decode_step``
  within ``tests/test_serve.py``'s 5e-3, the new cache in the caches'
  placements; experts, heads and width that do not divide the model axis
  (run replicated over it) against the port's unsharded step.
* ``launch.train.main(["--mesh", "2x4", ...])`` on the reduced preset,
  for qwen1.5-0.5b and for olmoe-1b-7b.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.checkpoint import save as jsave
from repro.models import build as jbuild
from repro.optim import AdamWConfig
from repro.serve.engine import make_decode_step
from repro.train.step import TrainConfig, init_train_state, make_train_step

# One torchrun of 8 ranks (about a minute): the slow tier, as
# tests/test_sharded.py.
pytestmark = pytest.mark.slow

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _train_inputs(arch, remat=None):
    cfg = jconfigs.get_reduced(arch)
    if arch == "gemma3-1b":
        import dataclasses

        cfg = dataclasses.replace(cfg, attn_chunk=4)
    model = jbuild(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0,
                                             mixed_precision=False),
                       xent_chunk=8)
    state = init_train_state(model, tcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                cfg.vocab_size, dtype=jnp.int32)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    s1, m1 = jax.jit(make_train_step(model, None, tcfg))(state, batch)
    return {"state": _np(state), "batch": _np(batch),
            "jax_loss": float(m1["loss"]), "jax_params": _np(s1["params"])}


#: The MoE, SSD and RG-LRU archs of the mesh scenarios.
FAMILIES = ("olmoe-1b-7b", "dbrx-132b", "mamba2-370m", "recurrentgemma-2b")


def _decode_inputs(arch):
    """JAX's plain decode step of ``arch`` reduced at batch 8 over a cache
    of 16 positions, every leaf drawn from N(0, 0.1²), positions 3-10."""
    cfg = jconfigs.get_reduced(arch)
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    cache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype),
        model.init_cache(8, 16))
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 1)), jnp.int32)
    pos = jnp.arange(3, 11, dtype=jnp.int32)
    logits, new = jax.jit(make_decode_step(model, None))(params, cache,
                                                         tokens, pos)
    return {"params": _np(params), "cache": _np(cache),
            "tokens": np.asarray(tokens), "pos": np.asarray(pos),
            "jax_logits": np.asarray(logits), "jax_cache": _np(new)}


def _cp_inputs():
    cfg = jconfigs.get_reduced("gemma3-1b")
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(2))
    cache = model.init_cache(1, 32)
    rng = np.random.default_rng(0)
    cache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype) * 0.1
        if x.ndim >= 4 else x, cache)
    tokens = jnp.asarray([[5]], jnp.int32)
    pos = jnp.asarray([3], jnp.int32)
    plain, _ = jax.jit(make_decode_step(model, None))(params, cache, tokens,
                                                      pos)
    return {"params": _np(params), "cache": _np(cache),
            "tokens": np.asarray(tokens), "pos": np.asarray(pos),
            "jax_logits": np.asarray(plain)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    rcfg = jconfigs.get_reduced("qwen1.5-0.5b")
    rparams = jbuild(rcfg).init(jax.random.PRNGKey(0))
    jck = os.path.join(d, "ck_jax")
    jsave(jck, rparams, step=3)
    inputs = {"train": _train_inputs("qwen2.5-3b"),
              "gemma_train": _train_inputs("gemma3-1b"),
              "cp": _cp_inputs(),
              "reshard": {"params": _np(rparams), "jax_ckpt": jck},
              "families": {a: _train_inputs(a) for a in FAMILIES},
              "decode": {a: _decode_inputs(a) for a in FAMILIES}}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "8", "--master-addr", "localhost", "--master-port",
         str(_free_port()), os.path.join(HERE, "_torch_mesh_ranks.py"), d],
        capture_output=True, text=True, timeout=420, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(os.path.join(d, "result.json")) as f:
        return json.load(f)


def test_sharded_step_matches_jax_single_device(result):
    r = result["train"]
    assert r["loss8"] == pytest.approx(r["loss_jax"], rel=1e-3)
    assert r["param_diff_jax"] < 5e-3
    assert r["loss8"] == pytest.approx(r["loss1"], rel=1e-5)
    assert r["m_rel_port"] < 1e-5
    assert r["placements_kept"]
    # FSDP weight grads leave as reduce-scatters onto the stored layout.
    assert r["comms"].get("reduce_scatter_tensor", 0) > 0


def test_pod_axis_step(result):
    """``pod_axis="pod"`` on (2, 2, 2): the step of the (2, 4) mesh and of
    one device, its grads averaged over the pod axis."""
    r = result["pod"]
    assert r["loss"] == pytest.approx(result["train"]["loss1"], rel=1e-5)
    assert r["m_rel_port"] < 1e-5
    assert r["param_diff_port"] < 5e-3
    assert r["comms"].get("all_reduce", 0) > 0


def test_sequence_sharded_attention_step_with_block_save(result):
    r = result["gemma_train"]
    assert r["loss8"] == pytest.approx(r["loss1"], rel=1e-5)
    assert r["m_rel_port"] < 1e-5


def test_uw_grad_is_a_reduce_scatter(result):
    r = result["uw"]
    assert r["comms"] == {"all_gather_into_tensor": 1,
                          "reduce_scatter_tensor": 1}
    assert r["grad_placements"] == ["Shard(0)", "Replicate"]


def test_cp_decode_matches_jax_plain_decode(result):
    r = result["cp"]
    assert r["diff_jax"] < 2e-3
    assert r["diff_port"] < 2e-3
    assert r["cache_diff"] < 2e-3
    n_attn = jconfigs.get_reduced("gemma3-1b").n_layers
    assert r["comms"]["all_reduce"] == 3 * n_attn


def test_checkpoint_elastic_reshard(result):
    assert result["landed"] == {"exact": True, "sharded": True}
    r = result["reshard"]
    assert r["exact"] and r["step"] == 1
    assert r["n_shards"] >= 2 and r["mesh_b"] == "torch.Size([4, 2])"
    assert r["jax_exact"] and r["jax_step"] == 3


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_matches_jax_single_device(result, arch):
    """The MoE, SSD and RG-LRU blocks on (2, 4): experts over the model
    axis (EP), SSD heads and RG-LRU width over it."""
    r = result["families"][arch]
    assert r["loss8"] == pytest.approx(r["loss_jax"], rel=1e-3)
    assert r["param_diff_jax"] < 5e-3
    assert r["loss8"] == pytest.approx(r["loss1"], rel=1e-5)
    assert r["m_rel_port"] < 1e-5
    assert r["placements_kept"]
    assert r["comms"].get("reduce_scatter_tensor", 0) > 0


def test_moe_step_with_block_save_and_aux(result):
    r = result["olmoe_block_save"]
    assert r["loss8"] == pytest.approx(r["loss1"], rel=1e-5)
    assert r["aux8"] == pytest.approx(r["aux1"], rel=1e-6, abs=1e-6)
    assert r["aux1"] > 0
    assert r["m_rel_port"] < 1e-5


def test_moe_expert_collectives(result):
    """Forward: the router and the three expert weights all-gathered over
    ``data`` (``uw``), the expert outputs over ``model`` (the reverse
    exchange), nothing else; backward: the expert weights' grads
    reduce-scattered over ``data``, no all-reduce of an expert weight."""
    r = result["moe_comms"]
    fwd = [tuple(row) for row in r["fwd"]]
    assert sorted(k for k, _, _ in fwd) == ["all_gather_into_tensor"] * 5
    assert ("all_gather_into_tensor", "model", r["exchange_numel"]) in fwd
    assert [a for _, a, _ in fwd].count("data") == 4
    bwd = [tuple(row) for row in r["bwd"]]
    expert_rs = [row for row in bwd
                 if row == ("reduce_scatter_tensor", "data",
                            r["expert_numel"])]
    assert len(expert_rs) == 3
    assert not [row for row in bwd if row[0] == "all_reduce"
                and row[2] >= r["expert_numel"]]
    assert all(r["grads_as_stored"].values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_jax_plain_decode(result, arch):
    r = result["decode"][arch]
    assert r["diff_jax"] < 5e-3
    assert r["cache_diff_jax"] < 5e-3
    assert r["placements_kept"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_undivided_layouts_run_replicated(result, arch):
    r = result["undivided"][arch]
    assert r["loss8"] == pytest.approx(r["loss1"], rel=1e-5)
    assert r["m_rel_port"] < 1e-5


def test_launcher_mesh_2x4(result):
    r = result["launch"]
    assert r["steps"] == 2 and r["restarts"] == 0
    assert np.isfinite(r["loss"]) and r["loss"] > 0


def test_launcher_moe_mesh_2x4(result):
    r = result["launch_moe"]
    assert r["steps"] == 2 and r["restarts"] == 0
    assert np.isfinite(r["loss"]) and r["loss"] > 0
