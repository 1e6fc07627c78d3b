"""Rank-side scenarios of ``tests/test_torch_sharded.py``: the port on a
mesh of 8 gloo ranks (``torchrun --nproc-per-node 8``), its inputs and the
JAX package's results read from ``<dir>/inputs.pkl`` (numpy trees the test
wrote), rank 0's findings written to ``<dir>/result.json``. Imports torch
and the port only.

    torchrun --nproc-per-node 8 tests/_torch_mesh_ranks.py <dir>
"""
import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.checkpoint import restore, save
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.configs import get_reduced
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import axis_sizes, make_mesh, set_mesh
from repro_torch.models import build
from repro_torch.models.layers import Axes, uw
from repro_torch.models.zoo import params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.serve.engine import make_decode_step
from repro_torch.sharding import (
    P,
    cache_pspecs,
    distribute,
    named_shardings,
    param_pspecs,
)
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import train_state_from_numpy

CPU = "cpu"


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def max_diff(a, b) -> float:
    return max(float((full(x).float() - full(y).float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def rel_diff(a, b) -> float:
    """Largest |a - b| over each leaf's largest |a|, over the leaves."""
    out = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = full(x).float(), full(y).float()
        scale = float(x.abs().max()) or 1.0
        out = max(out, float((x - y).abs().max()) / scale)
    return out


def names(p) -> str:
    return f"Shard({p.dim})" if p.is_shard() else type(p).__name__


def counts(cm) -> dict:
    return {str(k).split(".")[-1]: v for k, v in cm.get_comm_counts().items()}


def axes_for(mesh, **kw) -> Axes:
    names = mesh.mesh_dim_names
    return Axes(batch=tuple(a for a in ("pod", "data") if a in names),
                model="model", fsdp="data",
                sizes=tuple(axis_sizes(mesh).items()), **kw)


def tcfg_for() -> TrainConfig:
    return TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0,
                                             mixed_precision=False),
                       xent_chunk=8)


def sharded_step(arch, cfg, host, batch, mesh):
    """The port's unsharded step and its (data, model)-sharded step from
    the same state: (unsharded (state, metrics), sharded (state, metrics),
    collective counts of the sharded step)."""
    model = build(cfg)
    tcfg = tcfg_for()
    state = train_state_from_numpy(host, cfg, device=CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    s1, m1 = make_train_step(model, None, tcfg)(state, tb)
    sizes = axis_sizes(mesh)
    pspecs = param_pspecs(state["params"], sizes)
    specs = tlaunch.state_specs(state, pspecs)
    sstate = distribute(state, named_shardings(specs, mesh))
    sb = distribute(tb, named_shardings({k: P(("data",)) for k in tb}, mesh))
    step = make_train_step(model, axes_for(mesh), tcfg, grad_pspecs=pspecs)
    with set_mesh(mesh), CommDebugMode() as cm:
        s8, m8 = step(sstate, sb)
    return (s1, m1), (s8, m8), counts(cm)


def main(d: str) -> None:
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}

    # -- qwen2.5-3b reduced: the (2, 4) step against JAX's single-device
    # step and the port's unsharded step from the same state.
    q = inp["train"]
    cfg = get_reduced("qwen2.5-3b")
    (s1, m1), (s8, m8), cc = sharded_step("qwen2.5-3b", cfg, q["state"],
                                          q["batch"], mesh)
    jparams = params_from_numpy(q["jax_params"], cfg, device=CPU)
    res["train"] = {
        "loss_jax": q["jax_loss"], "loss1": float(m1["loss"]),
        "loss8": float(m8["loss"]),
        "param_diff_jax": max_diff(jparams, s8["params"]),
        "param_diff_port": max_diff(s1["params"], s8["params"]),
        "m_rel_port": rel_diff(s1["opt"]["m"], s8["opt"]["m"]),
        "comms": cc,
        "placements_kept": all(
            a.placements == b.placements for a, b in zip(
                tree_leaves(s8), tree_leaves(distribute(s1, named_shardings(
                    tlaunch.state_specs(s1, param_pspecs(
                        s1["params"], axis_sizes(mesh))), mesh))))),
    }

    # -- gemma3-1b reduced (2 heads on a model axis of 4: the
    # sequence-sharded attention), remat="block_save", against the port's
    # unsharded step.
    g = inp["gemma_train"]
    gcfg = dataclasses.replace(get_reduced("gemma3-1b"), attn_chunk=4,
                               remat="block_save")
    (g1, gm1), (g8, gm8), gcc = sharded_step("gemma3-1b", gcfg, g["state"],
                                             g["batch"], mesh)
    res["gemma_train"] = {"loss1": float(gm1["loss"]),
                          "loss8": float(gm8["loss"]),
                          "m_rel_port": rel_diff(g1["opt"]["m"],
                                                 g8["opt"]["m"]),
                          "comms": gcc}

    # -- uw: the weight gradient leaves as a reduce-scatter onto the
    # stored (fsdp) layout, with no all-reduce.
    torch.manual_seed(0)
    axes = axes_for(mesh)
    w = DTensor.from_local(torch.randn(16 // 2, 8), mesh,
                           [Shard(0), Replicate()]).requires_grad_()
    x = DTensor.from_local(torch.randn(4, 16), mesh,
                           [Shard(0), Replicate()])
    with CommDebugMode() as cm:
        y = torch.mm(x, uw(w, axes, None, None, fsdp_dim=0))
        y.sum().backward()
    res["uw"] = {"comms": counts(cm),
                 "grad_placements": [names(p) for p in w.grad.placements]}

    # -- gemma3-1b reduced: context-parallel decode on (8,) against JAX's
    # plain decode_step.
    c = inp["cp"]
    mesh8 = make_mesh((8,), ("data",), "cpu")
    ccfg = get_reduced("gemma3-1b")
    model = build(ccfg)
    params = params_from_numpy(c["params"], ccfg, device=CPU)
    cache = tree_map(torch.from_numpy, c["cache"])
    cspecs = cache_pspecs(cache, (), axis_sizes(mesh8), seq_shard=True)
    scache = distribute(cache, named_shardings(cspecs, mesh8))
    caxes = Axes(batch=(), model="model", fsdp="data", seq="data",
                 sizes=tuple(axis_sizes(mesh8).items()))
    with set_mesh(mesh8), CommDebugMode() as cm:
        lg, new = make_decode_step(model, caxes)(
            params, scache, torch.from_numpy(c["tokens"]),
            torch.from_numpy(c["pos"]))
    plain, _ = make_decode_step(model, None)(
        params, cache, torch.from_numpy(c["tokens"]),
        torch.from_numpy(c["pos"]))
    res["cp"] = {"diff_jax": float((full(lg) - torch.from_numpy(
                     c["jax_logits"])).abs().max()),
                 "diff_port": float((full(lg) - plain).abs().max()),
                 "cache_diff": max_diff(new, make_decode_step(model, None)(
                     params, cache, torch.from_numpy(c["tokens"]),
                     torch.from_numpy(c["pos"]))[1]),
                 "comms": counts(cm)}

    # -- the same step on (2, 2, 2) pod x data x model with
    # TrainConfig(pod_axis="pod"): the grads, whole on every pod rank,
    # averaged over the pod axis by an explicit all-reduce.
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    model = build(cfg)
    tcfg = dataclasses.replace(tcfg_for(), pod_axis="pod")
    state = train_state_from_numpy(q["state"], cfg, device=CPU)
    pspecs = param_pspecs(state["params"], axis_sizes(mesh3))
    sstate = distribute(state, named_shardings(
        tlaunch.state_specs(state, pspecs), mesh3))
    tb = {k: torch.from_numpy(v) for k, v in q["batch"].items()}
    sb = distribute(tb, named_shardings(
        {k: P(("pod", "data")) for k in tb}, mesh3))
    step = make_train_step(model, axes_for(mesh3), tcfg,
                           grad_pspecs=pspecs)
    with set_mesh(mesh3), CommDebugMode() as cm:
        s3, m3 = step(sstate, sb)
    res["pod"] = {"loss": float(m3["loss"]),
                  "param_diff_port": max_diff(s1["params"], s3["params"]),
                  "m_rel_port": rel_diff(s1["opt"]["m"], s3["opt"]["m"]),
                  "comms": counts(cm)}

    # -- qwen1.5-0.5b reduced: JAX's params landed sharded on (2, 4),
    # saved, restored onto (4, 2); and the checkpoint that repro wrote,
    # restored onto (4, 2).
    r = inp["reshard"]
    rcfg = get_reduced("qwen1.5-0.5b")
    rp = params_from_numpy(r["params"], rcfg, device=CPU)
    sh_a = named_shardings(param_pspecs(rp, axis_sizes(mesh)), mesh)
    ck = os.path.join(d, "ck_port")
    landed = params_from_numpy(r["params"], rcfg, shardings=sh_a)
    res["landed"] = {"exact": max_diff(rp, landed) == 0.0,
                     "sharded": any(p.is_shard() for x in tree_leaves(landed)
                                    for p in x.placements)}
    save(ck, landed, step=1)
    dist.barrier()
    mesh_b = make_mesh((4, 2), ("data", "model"), "cpu")
    sh_b = named_shardings(param_pspecs(rp, axis_sizes(mesh_b)), mesh_b)
    got, manifest = restore(ck, rp, shardings=sh_b)
    one = [x for x in tree_leaves(got) if x.ndim >= 2][0]
    jgot, jman = restore(r["jax_ckpt"], rp, shardings=sh_b)
    res["reshard"] = {
        "exact": max_diff(rp, got) == 0.0, "step": manifest["step"],
        "n_shards": int(np.prod([mesh_b.size(i) for i, p in
                                 enumerate(one.placements) if p.is_shard()])),
        "mesh_b": str(one.device_mesh.mesh.shape),
        "jax_exact": max_diff(rp, jgot) == 0.0, "jax_step": jman["step"]}

    # -- moe, ssm and recurrent under a mesh of 8 devices raise.
    raised = {}
    for arch in ("olmoe-1b-7b", "mamba2-370m", "recurrentgemma-2b"):
        acfg = get_reduced(arch)
        am = build(acfg)
        ap = am.init(torch.Generator().manual_seed(0), device=CPU)
        try:
            with set_mesh(mesh):
                am.forward(ap, {"tokens": torch.zeros((8, 8),
                                                      dtype=torch.int32)},
                           axes_for(mesh))
            raised[arch] = "ran"
        except NotImplementedError as e:
            raised[arch] = str(e)
    res["families"] = raised

    # -- the launcher's mesh path on (2, 4).
    rep = tlaunch.main(["--mesh", "2x4", "--steps", "2", "--batch", "8",
                        "--seq", "16", "--ckpt-dir",
                        os.path.join(d, "ck_launch")], device="cpu")
    res["launch"] = {"steps": rep.steps_run, "restarts": rep.restarts,
                     "loss": rep.final_metrics["loss"]}

    if rank == 0:
        with open(os.path.join(d, "result.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
