"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
the port of ``repro.models.rglru``.

The gated linear recurrence h_t = a_t ⊙ h_{t-1} + √(1-a_t²) ⊙ (i_t ⊙ x_t)
is associative, so prefill runs it as one parallel pass of log depth over
the sequence (JAX's ``lax.associative_scan``; torch has none public, so
:func:`linear_scan` doubles the reach of each step with JAX's ``combine``)
and decode keeps O(1) state. With the temporal conv and the gated output
branch this is the ``recurrent`` layer kind.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models import layers as L
from repro_torch.models.ssd import _causal_conv

_C = 8.0   # RG-LRU exponent scale (Griffin §2.4)


def init_rglru_block(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    rw = cfg.rglru_width or d
    dev = gen.device
    # Λ drawn so that a = σ(Λ)^c is spread over (0.9, 0.999).
    u = 0.9 + 0.099 * torch.rand((rw,), generator=gen, device=dev)
    lam = torch.log(u ** (1.0 / _C) / (1 - u ** (1.0 / _C)))
    return {
        "wx": L.dense_init(gen, d, rw, dtype),       # input branch
        "wg": L.dense_init(gen, d, rw, dtype),       # output gate branch
        "conv_w": (torch.randn((cfg.rglru_conv_width, rw), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((rw,), dtype=dtype, device=dev),
        "w_a": L.dense_init(gen, rw, rw, dtype),     # recurrence gate
        "b_a": torch.zeros((rw,), dtype=torch.float32, device=dev),
        "w_i": L.dense_init(gen, rw, rw, dtype),     # input gate
        "b_i": torch.zeros((rw,), dtype=torch.float32, device=dev),
        "lam": lam,
        "wo": L.dense_init(gen, rw, d, dtype),
    }


def _gates(p: dict, xb: torch.Tensor,
           x_all: Optional[torch.Tensor] = None):
    """Per-step decay a_t and gated input, both float32. ``x_all`` is the
    whole RG-LRU width of ``xb`` in float32 where ``xb`` is a slice of
    channels (``w_a``/``w_i`` then hold the slice's output columns)."""
    x32 = xb.float()
    xa = x32 if x_all is None else x_all
    r = torch.sigmoid(torch.einsum("bsr,rk->bsk", xa, p["w_a"].float())
                      + p["b_a"])
    i = torch.sigmoid(torch.einsum("bsr,rk->bsk", xa, p["w_i"].float())
                      + p["b_i"])
    log_a = _C * r * F.logsigmoid(p["lam"])[None, None, :]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * x32
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) along dim 1, in ⌈log2 S⌉
    parallel steps: step k joins each position with the one 2^k before
    it by JAX's ``combine`` ((a1, b1), (a2, b2)) -> (a1·a2, a2·b1 + b2)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_apply(p: dict, x: torch.Tensor, cfg, axes=None,
                return_state: bool = False):
    """Full-sequence recurrent block (prefill).

    ``return_state=True`` also returns the decode cache after the
    sequence (the scan's last hidden state and the conv's left context),
    so serving prefills a prompt in one pass and continues with
    :func:`rglru_decode`. Under a mesh it is :func:`_sharded_rglru`."""
    if axes is not None:
        return _sharded_rglru(p, x, cfg, axes, return_state)
    proj, state = _block(p, x)
    if return_state:
        return proj, state
    return proj


def _block(w: dict, x: torch.Tensor, gather=None
           ) -> Tuple[torch.Tensor, dict]:
    """The block on local tensors: ``w`` holds this rank's RG-LRU channels
    (``wx``/``wg`` columns, the conv's and gates' channels, ``wo`` rows)
    and ``gather`` gives the gates' float32 input over the whole width
    (None when the channels are the whole width). Returns (out, {"h",
    "conv"})."""
    xb = torch.einsum("bsd,dr->bsr", x, w["wx"])
    xb, conv_state = _causal_conv(xb, w["conv_w"], w["conv_b"],
                                  return_state=True)
    a, gated = _gates(w, xb, None if gather is None else gather(xb.float()))
    h = linear_scan(a, gated)
    # jax.nn.gelu: the tanh form, whatever cfg.act says.
    gate = F.gelu(torch.einsum("bsd,dr->bsr", x, w["wg"]), approximate="tanh")
    proj = torch.einsum("bsr,rd->bsd", h.to(x.dtype) * gate, w["wo"])
    return proj, {"h": h[:, -1], "conv": conv_state}


def _local_weights(p: dict, axes, m, tp: int, r: int, pdims, bdims):
    """This rank's block weights for its channels ``[r·rw/tp,
    (r+1)·rw/tp)``: ``wx``, ``wg``, ``conv_w``, ``w_a`` and ``w_i``
    (stored with the width over the model axis) unsharded by ``uw`` to
    their use layout, the width still split (the all-gathers over the
    fsdp axis only); ``wo`` to ``(model, None)``; the replicated 1-d
    leaves sliced. With the width whole every leaf is used whole.
    Gradients: partial over the rows' dims ``bdims`` (and the model dim
    for the sliced replicated leaves, in ``pdims``)."""
    rw = p["lam"].shape[0]
    ax = None if m is None else axes.model
    w = {k: L.local(L.uw(p[k], axes, None, ax), bdims)
         for k in ("wx", "wg", "conv_w", "w_a", "w_i")}
    w["wo"] = L.local(L.uw(p["wo"], axes, ax, None, fsdp_dim=1), bdims)
    rl = rw // tp
    for k in ("conv_b", "b_a", "b_i", "lam"):
        w[k] = L.whole(p[k], axes, pdims)[r * rl:(r + 1) * rl]
    return w


def _gather_width(mesh, m, row_placements, shape):
    """The gates' input: a float32 (B, S, rl) slice of channels, all-gathered
    over the model axis to the whole width; its gradient (each rank's
    columns of ``w_a``/``w_i`` read all channels) reduce-scattered back."""
    def gather(x32):
        part = L.with_placement(row_placements, m, Shard(2))
        full = L.from_local(x32, mesh, part, shape=shape)
        full = full.redistribute(mesh, row_placements)
        return full.to_local(grad_placements=L.with_placement(
            row_placements, m, Partial()))
    return gather


def _sharded_rglru(p: dict, x, cfg, axes: L.Axes, return_state: bool):
    """:func:`rglru_apply` on a mesh, JAX's placements (``repro.models
    .rglru``:69-85): ``xb`` sharded over the model axis on the RG-LRU
    width rw (``wx``, ``wg`` and ``conv_w`` used as stored, the width over
    the model axis, all-gathered over the fsdp axis); the conv and the
    doubling scan run per channel on the local channels. The gates contract
    ``xb`` over the whole width with ``w_a``/``w_i`` (stored ``P(None,
    model)``: each rank computes its own output columns), so ``xb`` is
    all-gathered over the model axis in float32 (its gradient
    reduce-scattered). The ``wg`` gate is local; ``wo`` used as ``(model,
    None)`` gives partial sums, all-reduced at the exit (``sc``). When rw
    does not divide the model axis every model rank runs the whole width,
    replicated. The batch stays sharded over the batch axes.

    ``return_state`` returns the cache as computed (rows over the batch
    axes, the width over the model axis); the caller lays it out as its
    cache."""
    mesh = L.mesh_of(x, p["wx"])
    x = L.sc(x, axes, axes.batch, None, None)
    bdims = L._shard_dims(x.placements, 0)
    rw = p["lam"].shape[0]
    m, tp, r = L.model_split(mesh, axes, rw)
    mdims = [] if m is None else [m]
    w = _local_weights(p, axes, m, tp, r, bdims + mdims, bdims)
    gather = None if m is None else _gather_width(
        mesh, m, x.placements, (*x.shape[:2], rw))
    out, state = _block(w, L.local(x, mdims), gather)
    out = L.from_local(out, mesh, L.with_placement(x.placements, m,
                                                   Partial()),
                       shape=x.shape)
    out = L.sc(out, axes, axes.batch, None, None)
    if not return_state:
        return out
    return out, _state(state, mesh, m, x.placements, x.shape[0], rw)


def _state(state: dict, mesh, m, row_placements, b: int, rw: int) -> dict:
    """This rank's rows and channels of the decode state as DTensors: rows
    as ``row_placements``, the width over the model dim ``m``."""
    out = {}
    for k, dim in (("h", 1), ("conv", 2)):
        t = state[k]
        pl = L.with_placement(row_placements, m, Shard(dim))
        out[k] = L.from_local(t, mesh, pl, shape=(b, *t.shape[1:dim], rw))
    return out


def init_rglru_cache(cfg, batch: int, dtype, device=None) -> dict:
    """The hidden state ``h`` in float32, the conv's left context in
    ``dtype``."""
    rw = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, rw), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, rw),
                            dtype=dtype, device=device),
    }


def rglru_decode(p: dict, x: torch.Tensor, cache: dict, cfg, axes=None
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent update. x (B, 1, D) -> (out, new cache). Under
    a mesh it is :func:`_sharded_rglru_decode`."""
    if axes is not None:
        return _sharded_rglru_decode(p, x, cache, cfg, axes)
    return _step(p, x, cache)


def _step(w: dict, x: torch.Tensor, cache: dict, gather=None):
    """One decode step on local tensors (``w``, the cache's channels and
    ``gather`` as :func:`_block` takes them)."""
    xb = torch.einsum("bsd,dr->bsr", x, w["wx"])
    xb, conv_state = _causal_conv(xb, w["conv_w"], w["conv_b"],
                                  state=cache["conv"])
    a, gated = _gates(w, xb, None if gather is None else gather(xb.float()))
    h = a[:, 0] * cache["h"] + gated[:, 0]
    gate = F.gelu(torch.einsum("bsd,dr->bsr", x, w["wg"]), approximate="tanh")
    out = h[:, None, :].to(x.dtype) * gate
    return (torch.einsum("bsr,rd->bsd", out, w["wo"]),
            {"h": h, "conv": conv_state})


def _sharded_rglru_decode(p: dict, x, cache: dict, cfg, axes: L.Axes):
    """:func:`rglru_decode` on a mesh: the width split over the model axis
    as in :func:`_sharded_rglru`, the whole batch on every rank (the
    caches of ``cache_pspecs`` are replicated over the batch axes; the
    one-token input is all-gathered instead). The conv cache, sharded over
    the model axis on the width as the channels are, is used as it lies;
    ``h`` (replicated) is sliced to the rank's channels. The new ``h`` is
    all-gathered over the model axis, and both are laid out as the cache
    given."""
    mesh = L.mesh_of(x, cache["h"], p["wx"])
    x = L.sc(x, axes, None, None, None)
    rep = tuple([Replicate()] * mesh.ndim)
    rw = p["lam"].shape[0]
    m, tp, r = L.model_split(mesh, axes, rw)
    mdims = [] if m is None else [m]
    w = _local_weights(p, axes, m, tp, r, mdims, [])
    cache = {k: L.replicate(v, mesh) for k, v in cache.items()}
    local = {k: cache[k].redistribute(mesh, L.with_placement(
        rep, m, Shard(dim))).to_local() for k, dim in (("h", 1), ("conv", 2))}
    gather = None if m is None else _gather_width(mesh, m, rep,
                                                  (x.shape[0], 1, rw))
    out, state = _step(w, x.to_local(), local, gather)
    out = L.from_local(out, mesh, L.with_placement(rep, m, Partial()),
                       shape=x.shape)
    out = L.sc(out, axes, axes.batch, None, None)
    new = _state(state, mesh, m, rep, x.shape[0], rw)
    return out, {k: new[k].redistribute(mesh, cache[k].placements)
                 for k in new}
