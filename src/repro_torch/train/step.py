"""Train step assembly — the port of ``repro.train.step``: forward (chunked
xent) -> grads -> (optional gradient compression) -> AdamW, with
microbatched gradient accumulation.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over detached
copies of the param leaves, so a step writes no tensor of the state it is
given and returns a new one, as JAX's does. Grads come in each param's
dtype (bf16 for bf16 params), as in JAX; microbatched accumulation runs in
float32 and then reports zero ``aux`` and ``tokens``, as JAX's scan does.
The step runs where the state's tensors lie. Under a mesh (``axes`` set,
the state and batch DTensors) ``grad_pspecs`` pins the grads and the
microbatch accumulator to the params' stored layout, and
``tcfg.pod_axis`` averages the grads over the pod mesh dim by an
explicit all-reduce (JAX's ``pmean``); the metrics come back whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.pytree import tree_map
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.zoo import Model, _tensor, params_from_numpy
from repro_torch.optim import (
    AdamWConfig,
    Compressor,
    apply_updates,
    compress_with_feedback,
    init_error,
    init_state,
)
from repro_torch.sharding.specs import to_placements
from repro_torch.train.loss import xent_chunked


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    compressor: Compressor = Compressor(kind="none")
    microbatches: int = 1
    xent_chunk: int = 512
    aux_weight: float = 0.01          # MoE load-balance weight
    # Explicit cross-pod pmean of a sharded step (a mesh axis name).
    pod_axis: Optional[str] = None


def make_loss_fn(model: Model, axes, tcfg: TrainConfig):
    """fn(params, batch) -> (loss, {"nll", "aux", "tokens"})."""
    cfg = model.cfg

    def fn(params, batch):
        hidden, aux = T.forward(params, batch, cfg, axes, return_hidden=True)
        labels = batch["labels"]
        if hidden.shape[1] != labels.shape[1]:
            # frontend prefix (VLM) carries no labels
            hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]

        def logits_fn(hc):
            return L.logits(params["embed"], hc, cfg, axes)

        nll, count = xent_chunked(hidden, labels, logits_fn,
                                  chunk=tcfg.xent_chunk)
        loss = nll + tcfg.aux_weight * aux
        return loss, {"nll": nll, "aux": aux, "tokens": count}

    return fn


def _value_and_grad(lfn):
    """``jax.value_and_grad(lfn, has_aux=True)``: ((loss, metrics),
    grads), everything detached; a param the loss does not reach gets a
    zero grad."""

    def fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = []
        tree_map(leaves.append, live)
        with torch.enable_grad():
            loss, metrics = lfn(live, batch)
            gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: _or_zeros(next(gs), p), live)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)

    return fn


def _or_zeros(g, p):
    """``p``'s grad: zeros where the loss does not reach it; a DTensor
    grad in ``p``'s placements (DTensor leaves the grad of a replicated
    leaf used on sharded activations as a partial sum)."""
    if g is None:
        return torch.zeros_like(p, requires_grad=False)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatches(batch: dict, mb: int, axes) -> list:
    """The ``mb`` microbatches of ``batch``: consecutive slices of its
    leading dim (JAX's reshape to (mb, B/mb, ...)); under a mesh each one
    laid out over the batch axes again."""
    if axes is None:
        parts = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                 for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(mb)]
    out = []
    for i in range(mb):
        mbatch = {}
        for k, v in batch.items():
            v = L.replicate(v, L.mesh_of(v, *batch.values()))
            full = v.redistribute(v.device_mesh,
                                  to_placements((), v.device_mesh))
            n = v.shape[0] // mb
            mbatch[k] = L.sc(full[i * n:(i + 1) * n], axes, axes.batch)
        out.append(mbatch)
    return out


def _pod_mean(g, axis: str):
    """JAX's ``pmean(g, axis)`` of a grad replicated over the mesh dim
    ``axis``: an all-reduce (avg) over that dim of each rank's slice."""
    from torch.distributed import _functional_collectives as funcol

    mesh = g.device_mesh
    dim = mesh.mesh_dim_names.index(axis)
    if g.placements[dim].is_shard():
        raise ValueError(f"a grad sharded over {axis!r}: pmean wants it "
                         "replicated there")
    return L.from_local(funcol.all_reduce(g.to_local(), "avg", (mesh, dim)),
                        mesh, g.placements)


def _whole(v):
    return v.full_tensor() if isinstance(v, DTensor) else v


def make_train_step(model: Model, axes, tcfg: TrainConfig,
                    grad_pspecs=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "error"(compression residual)}; batch holds
    tensors where the state lies, DTensors under a mesh (``axes`` set).
    ``grad_pspecs`` (a spec tree matching params) pins gradients and the
    micro-batch accumulator to the params' stored layout;
    ``tcfg.pod_axis`` averages the grads over that mesh axis. Both need
    ``axes``.
    """
    if axes is None and (grad_pspecs is not None
                         or tcfg.pod_axis is not None):
        raise ValueError("grad_pspecs and pod_axis place grads on a mesh: "
                         "pass axes (and DTensor state)")
    grad_fn = _value_and_grad(make_loss_fn(model, axes, tcfg))

    def pin(grads):
        if grad_pspecs is None:
            return grads
        return tree_map(lambda g, s: g.redistribute(
            g.device_mesh, to_placements(s, g.device_mesh)),
            grads, grad_pspecs)

    def compute_grads(params, batch):
        if tcfg.microbatches <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
            return loss, metrics, pin(grads)
        # Gradient accumulation: split batch on the leading dim.
        mb = tcfg.microbatches
        acc = pin(tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params))
        loss_sum = None
        for part in _microbatches(batch, mb, axes):
            (loss, _), grads = grad_fn(params, part)
            acc = pin(tree_map(torch.add, acc, pin(grads)))
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / mb
        grads = tree_map(lambda g: g * inv, acc)
        loss = loss_sum * inv
        zero = torch.zeros_like(loss)
        return loss, {"nll": loss, "aux": zero, "tokens": zero}, grads

    def train_step(state, batch):
        params, opt, error = state["params"], state["opt"], state["error"]
        loss, metrics, grads = compute_grads(params, batch)
        if tcfg.compressor.kind != "none":
            grads, error = compress_with_feedback(
                tcfg.compressor, grads, error)
        if tcfg.pod_axis is not None:
            # Cross-pod DP gradient all-reduce (DCN); in-pod reductions are
            # DTensor's own, from the batch sharding.
            grads = tree_map(lambda g: _pod_mean(g, tcfg.pod_axis), grads)
        params, opt, opt_metrics = apply_updates(
            tcfg.optimizer, params, grads, opt)
        metrics = {k: _whole(v)
                   for k, v in dict(metrics, loss=loss, **opt_metrics).items()}
        return {"params": params, "opt": opt, "error": error}, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> dict:
    """Params from ``model.init(generator, device)`` (default: seed 0 on
    the card), the optimizer state and the compression residual ({} with
    no compressor)."""
    params = model.init(generator, device)
    return {
        "params": params,
        "opt": init_state(tcfg.optimizer, params),
        "error": (init_error(params) if tcfg.compressor.kind != "none"
                  else {}),
    }


def train_state_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's train state (``jax.tree.map(np.asarray, state)``)
    as the port's on ``device`` (default: the card): the params through
    :func:`~repro_torch.models.zoo.params_from_numpy`, the optimizer's
    ``step``, ``m``, ``v`` and ``master`` and the residual ``error``,
    bfloat16 leaves by their bits."""
    dev = resolve_device(device)
    opt = tree["opt"]
    return {
        "params": params_from_numpy(tree["params"], cfg, dev),
        "opt": {"step": _tensor(opt["step"], dev),
                **{k: params_from_numpy(opt[k], cfg, dev)
                   for k in ("m", "v", "master") if k in opt}},
        "error": (params_from_numpy(tree["error"], cfg, dev)
                  if tree["error"] else {}),
    }
