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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.formats.ell import EllMatrix
from repro_torch.models import layers as L
from repro_torch.obs import trace


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / (d ** 0.5)

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * s).to(dtype)

    p = {
        "router": L.dense_init(gen, d, e, torch.float32),
        "wi": normal((e, d, f), scale),
        "wg": normal((e, d, f), scale),
        "wo": normal((e, f, d), 1.0 / f ** 0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, dtype,
                                 d_ff=cfg.n_shared_experts * f)
    return p


def _route(router: torch.Tensor, xf: torch.Tensor, cfg):
    """xf (T, D) -> (weights (T, k) float32, experts (T, k) int32): the
    router runs in float32 whatever the model's dtype; the top k come in
    descending order. ``router_scoring`` "topk_softmax": a softmax over
    the top k logits; "softmax" (DeepSeek-V2): a softmax over all E, the
    top k shares kept unrenormalised (its ``routed_scaling_factor`` is
    1)."""
    logits = torch.einsum("td,de->te", xf.float(), router)
    if cfg.router_scoring == "softmax":
        weights, idx = torch.topk(torch.softmax(logits, dim=-1),
                                  cfg.experts_per_token, dim=-1, sorted=True)
        return weights, idx.to(torch.int32)
    weights, idx = torch.topk(logits, cfg.experts_per_token, dim=-1,
                              sorted=True)
    return torch.softmax(weights, dim=-1), idx.to(torch.int32)


def moe_mlp(p: dict, x: torch.Tensor, cfg, axes=None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Capacity-bounded top-k MoE (dbrx 16e/top-4, olmoe 64e/top-8).

    Capacity is per sequence (C = max(8, int(S·k·cf/E))); each (token,
    choice) takes the next slot of its expert in token-major order, and
    those past the capacity drop (one-token decode never drops). Shared
    experts (``n_shared_experts``), one SwiGLU on every token, are added
    to the routed sum (span ``repro.moe.shared``). Returns
    (out (B, S, D), (weights (B·S, k), experts (B·S, k))). The output is
    named ``moe_out`` for the remat policies.

    Under a mesh (:func:`_sharded_moe`) the routing and dispatch run on
    each rank's batch shard and the experts over the model axis (EP)."""
    if axes is not None:
        return _sharded_moe(p, x, cfg, axes)
    e = cfg.n_experts
    out_buf, (weights, idx, slot, w) = _dispatch_ffn(
        p["router"], p["wi"], p["wg"], p["wo"], x, x, cfg, 0, e)
    out = _combine(out_buf, slot, w)
    if "shared" in p:
        with trace.TRACE.span("repro.moe.shared"):
            out = out + L.mlp(p["shared"], x, cfg)
    return L.checkpoint_name(out, "moe_out"), (weights, idx)


def _dispatch_ffn(router, wi, wg, wo, xr, xd, cfg, e0: int, el: int):
    """Routing, capacity dispatch and the FFN of experts ``[e0, e0 +
    el)`` on local tensors: ``xr`` (B, S, D) feeds the router, ``xd`` (the
    same values) the dispatch gather. Returns (out_buf (B, el, cap, D),
    (weights, experts, slot (B, S·k), combine weights (B, S, k)))."""
    b, s, d = xr.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(8, int(s * k * cfg.capacity_factor / e))
    weights, idx = _route(router, xr.reshape(b * s, d), cfg)
    idx_r = idx.reshape(b, s * k).long()                     # (B, S·k)
    w_r = weights.reshape(b, s, k)
    rows = torch.arange(b, device=xr.device)[:, None]

    if s == 1 and el == e:
        # One token a row takes each of its k experts once, at slot 0:
        # nothing drops, so no ranks and no inverse map (the slots it
        # fills and their values are the general path's).
        slot = idx_r * cap                                   # (B, k)
        buf = xd.new_zeros((b, e * cap, d)).index_put_(
            (rows, slot), xd[:, 0, None, :].expand(b, k, d))
        w = w_r
    else:
        # Per-row exclusive rank of each (token, choice) within its
        # expert.
        onehot = F.one_hot(idx_r, e).to(torch.int32)         # (B, S·k, E)
        ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        pos = torch.gather(ranks, 2, idx_r[..., None])[..., 0]
        keep = pos < cap
        slot = torch.where(keep, idx_r * cap + pos, e * cap)  # (B, S·k)

        # Dispatch: scatter the int32 inverse map (slot -> source), then
        # gather the activations of experts [e0, e0 + el). Only the
        # sentinel column e·cap takes more than one index, and it is
        # dropped.
        j_ids = torch.arange(s * k, dtype=torch.int32,
                             device=xr.device).expand(b, s * k)
        inv = torch.full((b, e * cap + 1), -1, dtype=torch.int32,
                         device=xr.device)
        inv = inv.scatter(1, slot, j_ids)[:, e0 * cap:(e0 + el) * cap]
        tok = torch.where(inv >= 0, inv // k, 0).long()
        buf = xd[rows, tok]                                  # (B, el·cap, D)
        buf = buf * (inv >= 0)[..., None].to(buf.dtype)
        w = w_r * keep.reshape(b, s, k)
    buf = buf.reshape(b, el, cap, d)

    # Expert FFN, batched over (row, expert).
    h = torch.einsum("becd,edf->becf", buf, wi)
    if cfg.act == "silu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * h
    else:
        h = L.activation(h, cfg.act)
    out_buf = torch.einsum("becf,efd->becd", h, wo)
    return out_buf, (weights, idx, slot, w)


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """Gather each (token, choice) result of ``out_buf`` (B, E, cap, D)
    at its ``slot`` (the sentinel E·cap reads zeros), weight and sum."""
    b, s, k = w.shape
    d = out_buf.shape[-1]
    out_buf = out_buf.reshape(b, -1, d)
    if s > 1:            # one token a row drops nothing: no sentinel
        out_buf = torch.cat([out_buf, out_buf.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=out_buf.device)[:, None]
    gathered = out_buf[rows, slot].reshape(b, s, k, d)
    return torch.einsum("bskd,bsk->bsd", gathered, w.to(gathered.dtype))


def _sharded_moe(p: dict, x, cfg, axes: L.Axes):
    """:func:`moe_mlp` on a mesh, JAX's placements (``repro.models.moe``
    :83-113) with collectives stated:

    * ``x`` is batch-local, replicated over the model axis (``sc``). The
      routing, the rank cumsum, the inverse scatter and the dispatch
      gather run on each rank's batch shard (capacity is per sequence, so
      no row needs another shard). The router (stored ``P(data, None)``)
      is used whole: all-gathered, its gradient a partial sum over the
      batch axes, reduce-scattered.
    * Expert parallelism: when E divides the model axis (``axes.tp``)
      each model rank gathers and runs only its E/tp experts (``buf`` laid
      out ``(batch, model, None, None)``, a local slice with no
      collective), with ``wi``/``wg``/``wo`` unsharded by ``uw`` to
      ``(model, None, None)``: all-gathers over the fsdp axis, their
      gradients reduce-scattered back. The dispatch's gradient to ``x`` is
      then a partial sum over the model axis.
    * The reverse exchange: ``out_buf`` returns to ``(batch, None, ...)``
      before the combine by one all-gather over the model axis. Its
      backward is a local slice: the combine runs whole on every model
      rank, and the ``sc`` at the block exit hands it the whole gradient
      (all-reduced there).
    * When E does not divide the model axis every model rank runs all the
      experts, replicated (JAX's ``axes.tp`` rule), and nothing is
      exchanged.

    The routing comes back as DTensors sharded as the batch rows, for
    :func:`aux_load_balance_loss`."""
    mesh = L.mesh_of(x, p["router"])
    x = L.sc(x, axes, axes.batch, None, None)
    e = cfg.n_experts
    bdims = L._shard_dims(x.placements, 0)
    m, tp, r = L.model_split(mesh, axes, e)
    el = e // tp
    e_ax = axes.model if m is not None else None
    router = L.whole(p["router"], axes, bdims)
    ws = [L.local(L.uw(p[n], axes, e_ax, None, None), bdims)
          for n in ("wi", "wg", "wo")]
    xr = x.to_local()
    xd = xr if m is None else L.local(x, [m])
    out_buf, (weights, idx, slot, w) = _dispatch_ffn(
        router, *ws, xr, xd, cfg, r * el, el)
    if m is not None:
        b = x.shape[0]
        out_buf = L.from_local(
            out_buf, mesh, L.with_placement(x.placements, m, Shard(1)),
            shape=(b, e, *out_buf.shape[2:]))
        out_buf = out_buf.redistribute(mesh, x.placements).to_local()
    out = L.from_local(_combine(out_buf, slot, w), mesh, x.placements,
                       shape=x.shape)
    out = L.sc(out, axes, axes.batch, None, None)
    t = x.shape[0] * x.shape[1]
    routing = tuple(L.from_local(v, mesh, x.placements,
                                 shape=(t, v.shape[1]))
                    for v in (weights, idx))
    return L.checkpoint_name(out, "moe_out"), routing


def aux_load_balance_loss(weights: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E · Σ_e (share of
    assignments to e) · (mean router mass on e), both over all T tokens.

    For routing DTensors sharded as batch rows (:func:`_sharded_moe`) each
    rank sums its rows, the two (E,) sums are all-reduced over the batch
    axes and divided by the global T; the loss is replicated."""
    mesh = None
    if isinstance(weights, DTensor):
        mesh, pl = weights.device_mesh, weights.placements
        t = weights.shape[0]
        weights, idx = weights.to_local(), idx.to_local()
    else:
        t = idx.shape[0]
    assign = F.one_hot(idx.long(), n_experts).float().sum(dim=1)  # (T, E)
    # density of router probability mass per expert
    full = torch.zeros((idx.shape[0], n_experts), dtype=weights.dtype,
                       device=weights.device)
    full = full.scatter_add(1, idx.long(), weights)
    sums = torch.stack([assign.sum(dim=0), full.sum(dim=0)])
    if mesh is not None:
        sums = L.psum(sums, mesh, L._shard_dims(pl, 0))
    frac_tokens, frac_probs = sums / t
    loss = n_experts * torch.sum(frac_tokens * frac_probs)
    if mesh is None:
        return loss
    return L.from_local(loss, mesh, [Replicate()] * mesh.ndim)


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
