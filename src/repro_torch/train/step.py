"""Train step assembly — the port of ``repro.train.step``: forward (chunked
xent) -> grads -> (optional gradient compression) -> AdamW, with
microbatched gradient accumulation.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over detached
copies of the param leaves, so a step writes no tensor of the state it is
given and returns a new one, as JAX's does. Grads come in each param's
dtype (bf16 for bf16 params), as in JAX; microbatched accumulation runs in
float32 and then reports zero ``aux`` and ``tokens``, as JAX's scan does.
The step runs where the state's tensors lie. The pod-axis all-reduce and
``grad_pspecs`` (sharded steps) come with the sharding slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
from repro_torch.train.loss import xent_chunked


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    compressor: Compressor = Compressor(kind="none")
    microbatches: int = 1
    xent_chunk: int = 512
    aux_weight: float = 0.01          # MoE load-balance weight
    # Explicit cross-pod pmean of a sharded step; must be None on one card.
    pod_axis: Optional[str] = None


def make_loss_fn(model: Model, axes, tcfg: TrainConfig):
    """fn(params, batch) -> (loss, {"nll", "aux", "tokens"})."""
    L.check_axes(axes)
    cfg = model.cfg

    def fn(params, batch):
        hidden, aux = T.forward(params, batch, cfg, return_hidden=True)
        labels = batch["labels"]
        if hidden.shape[1] != labels.shape[1]:
            # frontend prefix (VLM) carries no labels
            hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]

        def logits_fn(hc):
            return L.logits(params["embed"], hc, cfg)

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
    return torch.zeros_like(p, requires_grad=False) if g is None else g


def make_train_step(model: Model, axes, tcfg: TrainConfig,
                    grad_pspecs=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "error"(compression residual)}; batch holds
    tensors where the state lies. ``grad_pspecs`` and ``tcfg.pod_axis``
    pin and reduce grads across a mesh; one card has none, so both must be
    None.
    """
    if grad_pspecs is not None or tcfg.pod_axis is not None:
        raise NotImplementedError(
            "grad_pspecs and pod_axis shard the step across a mesh; "
            "repro_torch trains on one card (the sharding slice, ROADMAP.md "
            "queue 1 item 3)")
    grad_fn = _value_and_grad(make_loss_fn(model, axes, tcfg))

    def compute_grads(params, batch):
        if tcfg.microbatches <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
            return loss, metrics, grads
        # Gradient accumulation: split batch on the leading dim.
        mb = tcfg.microbatches
        parts = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(mb):
            (loss, _), grads = grad_fn(params,
                                       {k: v[i] for k, v in parts.items()})
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
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
        params, opt, opt_metrics = apply_updates(
            tcfg.optimizer, params, grads, opt)
        metrics = dict(metrics, loss=loss, **opt_metrics)
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
