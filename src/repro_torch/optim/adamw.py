"""AdamW with learning-rate schedules, global-norm clipping and optional
mixed precision (bf16 params + fp32 master copies + fp32 moments) — the
port of ``repro.optim.adamw``, with its exact semantics.

Functional, as JAX's: :func:`apply_updates` returns new params and a new
state and writes no tensor it was given, so a caller may keep an earlier
state (a replay from the same start, a checkpoint snapshot in flight).
``torch.optim.AdamW`` is not used: it decays every param and clips
elsewhere. Here, as in JAX:

* grads are clipped by their global norm over all leaves;
* the step is incremented before :func:`lr_at`, so the first update uses
  ``lr / warmup_steps``, and bias correction uses that step;
* weight decay applies where the stored leaf has ``ndim >= 2`` — a stacked
  period's norm scale, (n_periods, d), is decayed too;
* with ``mixed_precision`` the update runs on float32 master copies, and
  the new params are cast back to each param's dtype.

Scalars are float32 tensors on the params' device; nothing reads them on
the host. The leaves may be DTensors (a sharded step): every op is
DTensor's, so the global norm's sums of squares, partial on each shard,
are all-reduced before the square root.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map, tree_map_n


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    mixed_precision: bool = True     # fp32 master copies for low-prec params


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio·lr."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(cfg: AdamWConfig, params) -> dict:
    """Step 0 (int32), zero float32 moments and, with ``mixed_precision``,
    float32 master copies, on the params' device."""
    dev = tree_leaves(params)[0].device
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if cfg.mixed_precision:
        state["master"] = tree_map(lambda p: p.to(torch.float32), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32, the leaves
    summed in JAX's order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 scalar ``x`` as a tensor of ``like``'s kind (a
    replicated DTensor beside one)."""
    return torch.full_like(like, x, dtype=torch.float32)


def apply_updates(cfg: AdamWConfig, params, grads, state,
                  compressor: Optional[Any] = None
                  ) -> Tuple[Any, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics).
    ``compressor`` is accepted and unused, as in JAX's signature."""
    gnorm = global_norm(grads)
    # A float over a tensor is reciprocal-then-multiply in torch; divide
    # tensor by tensor to round as JAX does.
    scale = torch.clamp_max(_f32(cfg.grad_clip, gnorm)
                            / torch.clamp_min(gnorm, 1e-9), 1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    step = state["step"] + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.beta1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.beta2, stepf), stepf)
    masters = state.get("master", params)

    def upd(p_master, g, m, v):
        m2 = cfg.beta1 * m + (1 - cfg.beta1) * g
        v2 = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p_master.to(torch.float32)
        if p_master.ndim >= 2:
            delta = delta + cfg.weight_decay * p32
        return p32 - lr * delta, m2, v2

    new_master, new_m, new_v = tree_map_n(upd, 3, masters, grads,
                                          state["m"], state["v"])
    new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master, params)
    new_state = {"step": step, "m": new_m, "v": new_v}
    if cfg.mixed_precision:
        new_state["master"] = new_master
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, new_state, metrics
