"""Mixture-of-Experts FFN — the port of ``repro.models.moe``, the paper's
technique as a model feature.

The routing matrix R (tokens × experts, top-k nonzeros per row) is a
``U_T C_E`` compressed tensor in the paper's taxonomy, and combine is the
EIE-like SpMM dataflow. :func:`moe_mlp` runs the static-capacity
gather/combine of the JAX package (capacity per sequence, overflowing
tokens dropped); :func:`routing_as_ell` exposes the same routing tensor as
the port's :class:`~repro_torch.formats.ell.EllMatrix`, which
``repro_torch.kernels.ops.spmm_mirror`` multiplies on the card with the
port's SpMM kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.formats.ell import EllMatrix
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / (d ** 0.5)

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * s).to(dtype)

    return {
        "router": L.dense_init(gen, d, e, torch.float32),
        "wi": normal((e, d, f), scale),
        "wg": normal((e, d, f), scale),
        "wo": normal((e, f, d), 1.0 / f ** 0.5),
    }


def _route(p: dict, xf: torch.Tensor, cfg):
    """xf (T, D) -> (weights (T, k) float32, experts (T, k) int32): the
    router runs in float32 whatever the model's dtype; the top k come in
    descending order, then a softmax over them."""
    logits = torch.einsum("td,de->te", xf.float(), p["router"])
    weights, idx = torch.topk(logits, cfg.experts_per_token, dim=-1,
                              sorted=True)
    return torch.softmax(weights, dim=-1), idx.to(torch.int32)


def moe_mlp(p: dict, x: torch.Tensor, cfg, axes=None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Capacity-bounded top-k MoE (dbrx 16e/top-4, olmoe 64e/top-8).

    Capacity is per sequence (C = max(8, int(S·k·cf/E))); each (token,
    choice) takes the next slot of its expert in token-major order, and
    those past the capacity drop (one-token decode never drops). Returns
    (out (B, S, D), (weights (B·S, k), experts (B·S, k))).
    """
    L.check_axes(axes)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(8, int(s * k * cfg.capacity_factor / e))
    weights, idx = _route(p, x.reshape(b * s, d), cfg)       # (B·S, k)
    idx_r = idx.reshape(b, s * k).long()                     # (B, S·k)
    w_r = weights.reshape(b, s, k)

    # Per-row exclusive rank of each (token, choice) within its expert.
    onehot = F.one_hot(idx_r, e).to(torch.int32)             # (B, S·k, E)
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(ranks, 2, idx_r[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, idx_r * cap + pos, e * cap)     # (B, S·k)

    # Dispatch: scatter the int32 inverse map (slot -> source), then
    # gather the activations. Only the sentinel column e·cap takes more
    # than one index, and it is dropped.
    j_ids = torch.arange(s * k, dtype=torch.int32,
                         device=x.device).expand(b, s * k)
    inv = torch.full((b, e * cap + 1), -1, dtype=torch.int32,
                     device=x.device)
    inv = inv.scatter(1, slot, j_ids)[:, :-1]                # (B, E·cap)
    tok = torch.where(inv >= 0, inv // k, 0).long()
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x[rows, tok]                                       # (B, E·cap, D)
    buf = buf * (inv >= 0)[..., None].to(buf.dtype)
    buf = buf.reshape(b, e, cap, d)

    # Expert FFN, batched over (row, expert).
    h = torch.einsum("becd,edf->becf", buf, p["wi"])
    if cfg.act == "silu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"])) * h
    else:
        h = L.activation(h, cfg.act)
    out_buf = torch.einsum("becf,efd->becd", h, p["wo"])
    out_buf = out_buf.reshape(b, e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((b, 1, d))], dim=1)

    # Combine: gather each (token, choice) result, weight and sum.
    gathered = out_buf[rows, slot].reshape(b, s, k, d)
    w = (w_r * keep.reshape(b, s, k)).to(gathered.dtype)
    out = torch.einsum("bskd,bsk->bsd", gathered, w)
    return out, (weights, idx)


def aux_load_balance_loss(weights: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    t, k = idx.shape
    assign = F.one_hot(idx.long(), n_experts).float().sum(dim=1)  # (T, E)
    frac_tokens = assign.mean(dim=0)
    # density of router probability mass per expert
    full = torch.zeros((t, n_experts), dtype=weights.dtype,
                       device=weights.device)
    full = full.scatter_add(1, idx.long(), weights)
    frac_probs = full.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)


def routing_as_ell(weights: torch.Tensor, idx: torch.Tensor,
                   n_experts: int) -> EllMatrix:
    """Expose routing as the paper's U_T C_E compressed matrix: an
    :class:`EllMatrix` whose fibers are tokens and whose coordinates are
    expert ids (ascending, by a stable sort), so that dispatch is the
    EIE-like SpMM ``R (T×E, sparse) × expert summaries (E×D, dense)``."""
    t, k = idx.shape
    order = torch.argsort(idx, dim=1, stable=True)
    ids = torch.gather(idx, 1, order).to(torch.int32)
    vals = torch.gather(weights, 1, order)
    return EllMatrix(vals=vals, ids=ids,
                     lens=torch.full((t,), k, dtype=torch.int32,
                                     device=idx.device),
                     shape=(t, n_experts), major_axis=0)
