"""Mamba2 / SSD (state-space duality) block — the port of
``repro.models.ssd`` (arXiv:2405.21060).

Prefill runs the chunked SSD algorithm: quadratic attention-like compute
within chunks and a linear recurrence across the chunk-final states (JAX's
``lax.scan`` over chunks becomes a loop over chunks). Decoding is the
O(1)-state recurrent update. Torch ops only: the JAX package computes the
scan with XLA einsums, outside any Pallas kernel, so there is no kernel
here to port.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models import layers as L


def init_mamba(gen: torch.Generator, cfg, dtype) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n                    # conv over (x, B, C)
    dev = gen.device
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * n + h, dtype),
        "conv_w": (torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm_z": L.rmsnorm_init(di, dtype, dev),
        "out_proj": L.dense_init(gen, di, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 return_state: bool = False):
    """Depthwise causal conv1d. x (B, S, C), w (W, C): JAX's sum of W
    shifted slices, in the same order.

    With ``state`` (B, W-1, C) (decode) it is the left context and the
    result is (y, new_state). ``return_state=True`` on the full sequence
    (prefill) also returns the trailing W-1 inputs, the left context the
    next decode step needs.
    """
    width, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    y = F.silu(y + b[None, None, :])
    if state is None and not return_state:
        return y
    return y, xp[:, -(width - 1):, :]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> (..., q, q) lower-triangular segment sums,
    S[i, j] = Σ_{j<l<=i} a_l, and -inf above the diagonal."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    s = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, a_head, b, c, chunk: int):
    """Chunked SSD scan.

    x (B, S, H, P); dt (B, S, H) (after softplus); a_head (H,) =
    -exp(A_log); b, c (B, S, N) (one group). Returns y (B, S, H, P) in
    float32 and the final state (B, H, P, N).
    """
    bsz, s, h, p_ = x.shape
    n = b.shape[-1]
    nc, q = s // chunk, chunk

    xr = x.reshape(bsz, nc, q, h, p_).float()
    dtr = dt.reshape(bsz, nc, q, h)
    br = b.reshape(bsz, nc, q, n).float()
    cr = c.reshape(bsz, nc, q, n).float()
    da = dtr * a_head[None, None, None, :]                   # (B, nc, q, H)
    xbar = xr * dtr[..., None]                               # dt-weighted input

    # Intra-chunk (quadratic within the chunk, like attention).
    lmat = torch.exp(_segsum(da.transpose(2, 3)))            # (B, nc, H, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", cr, br)         # (B, nc, q, q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", lmat * scores[:, :, None],
                          xbar)

    # Chunk-final states, then the recurrence across chunks.
    cumsum_da = torch.cumsum(da, dim=2)                      # (B, nc, q, H)
    decay_to_end = torch.exp(cumsum_da[:, :, -1:, :] - cumsum_da)
    states = torch.einsum("bcqn,bcqhp->bchpn", br,
                          xbar * decay_to_end[..., None])    # (B, nc, H, P, N)
    chunk_decay = torch.exp(cumsum_da[:, :, -1, :])          # (B, nc, H)
    h_run = torch.zeros((bsz, h, p_, n), dtype=torch.float32,
                        device=x.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h_run)
        h_run = h_run * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                     # (B, nc, H, P, N)

    # Inter-chunk contribution: a decayed read of the incoming state.
    decay_from_start = torch.exp(cumsum_da)                  # (B, nc, q, H)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", cr, h_prev)
             * decay_from_start[..., None])
    return (y_diag + y_off).reshape(bsz, s, h, p_), h_run


def mamba_apply(p: dict, x: torch.Tensor, cfg, axes=None,
                return_state: bool = False):
    """Full-sequence Mamba2 mixer (prefill).

    ``return_state=True`` also returns the decode cache after the sequence
    (the chunked scan's final state and the conv's left context), so
    serving prefills a prompt in one pass and continues with
    :func:`mamba_decode`. A length that ``ssm_chunk`` does not divide
    takes the largest common divisor as its chunk (the same recurrence,
    smaller chunks). Under a mesh it is :func:`_sharded_mamba`."""
    if axes is not None:
        return _sharded_mamba(p, x, cfg, axes, return_state)
    out, state = _mix(p, x, cfg, cfg.ssm_heads, _split_norm(cfg))
    if return_state:
        return out, state
    return out


def _mix(w: dict, x: torch.Tensor, cfg, hl: int, norm):
    """The mixer over ``hl`` heads on local tensors: ``w`` holds
    ``in_proj`` columns [z, x, B, C, dt] of those heads (B and C whole),
    the conv's [x, B, C] channels, their per-head leaves and ``norm_z``
    slice, and ``out_proj`` rows; ``norm`` is the gated RMSNorm over the
    whole d_inner. Returns (out, {"h", "conv"})."""
    bsz, s, _ = x.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    dl = hl * hp
    proj = torch.einsum("bsd,dk->bsk", x, w["in_proj"])
    z, xbc, dt = (proj[..., :dl], proj[..., dl:dl + dl + 2 * n],
                  proj[..., dl + dl + 2 * n:])
    xbc, conv_state = _causal_conv(xbc, w["conv_w"], w["conv_b"],
                                   return_state=True)
    xs, b, c = xbc[..., :dl], xbc[..., dl:dl + n], xbc[..., dl + n:]
    dt = F.softplus(dt.float() + w["dt_bias"])
    a_head = -torch.exp(w["A_log"])
    xh = xs.reshape(bsz, s, hl, hp)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s)
    y, h_last = ssd_chunked(xh, dt, a_head, b, c, chunk)
    y = y + w["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, dl).to(x.dtype)
    y = norm(y * F.silu(z), w["norm_z"])
    out = torch.einsum("bsk,kd->bsd", y, w["out_proj"])
    return out, {"h": h_last, "conv": conv_state}


def _local_weights(p: dict, cfg, axes, m, tp: int, r: int, pdims, bdims):
    """This rank's mixer weights (:func:`_mix`) for its heads ``[r·h/tp,
    (r+1)·h/tp)``: ``in_proj``, ``conv_w``, ``conv_b`` and the per-head
    leaves used whole (all-gathered; gradients partial over ``pdims``)
    and sliced to the heads' z, x and dt channels and the whole of B and
    C (2n channels that every head reads); ``out_proj`` unsharded at its
    use layout ``(model, None)`` (``(None, None)`` when the heads are not
    split), its rows the heads' d_inner slice."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hl = h // tp
    dl = hl * cfg.ssm_head_dim
    w = {k: L.whole(p[k], axes, pdims)
         for k in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                   "norm_z")}
    if m is None:
        w["out_proj"] = L.whole(p["out_proj"], axes, bdims)
        return w
    z0, t0 = r * dl, 2 * di + 2 * n + r * hl
    wi = w["in_proj"]
    w["in_proj"] = torch.cat([wi[:, z0:z0 + dl], wi[:, di + z0:di + z0 + dl],
                              wi[:, 2 * di:2 * di + 2 * n], wi[:, t0:t0 + hl]],
                             dim=1)
    for k in ("conv_w", "conv_b"):
        w[k] = torch.cat([w[k][..., z0:z0 + dl], w[k][..., di:]], dim=-1)
    for k in ("A_log", "D", "dt_bias"):
        w[k] = w[k][r * hl:(r + 1) * hl]
    w["norm_z"] = w["norm_z"][z0:z0 + dl]
    w["out_proj"] = L.local(L.uw(p["out_proj"], axes, axes.model, None,
                                 fsdp_dim=1), bdims)
    return w


def _split_norm(cfg, mesh=None, m=None):
    """The gated RMSNorm over d_inner, split over the model dim ``m``."""
    return functools.partial(L.split_rmsnorm, eps=cfg.norm_eps,
                             n=cfg.d_inner, mesh=mesh,
                             dims=() if m is None else (m,))


def _state(state: dict, mesh, cfg, m, row_placements, b: int) -> dict:
    """The decode state of this rank's rows and heads (``h`` (b, hl, P,
    N), ``conv`` (b, W-1, [x of its heads, B, C])) as DTensors: ``h``
    with rows as ``row_placements`` and heads over the model dim ``m``;
    ``conv`` whole, replicated on every mesh dim (its x channels
    all-gathered over the rows' and heads' dims, B and C, the same on
    every model rank, over the rows' dims only: the heads' channels do
    not line up with the cache's shards of the conv width)."""
    di, n = cfg.d_inner, cfg.ssm_state
    rep = [Replicate()] * mesh.ndim
    hpl = L.with_placement(row_placements, m, Shard(1))
    xpl = L.with_placement(row_placements, m, Shard(2))
    dl = state["conv"].shape[2] - 2 * n
    w1 = state["conv"].shape[1]
    h = L.from_local(state["h"], mesh, hpl,
                     shape=(b, cfg.ssm_heads, *state["h"].shape[2:]))
    cx = L.from_local(state["conv"][..., :dl], mesh, xpl, shape=(b, w1, di))
    cbc = L.from_local(state["conv"][..., dl:], mesh, row_placements,
                       shape=(b, w1, 2 * n))
    conv = torch.cat([cx.redistribute(mesh, rep).to_local(),
                      cbc.redistribute(mesh, rep).to_local()], dim=2)
    return {"h": h, "conv": L.from_local(conv, mesh, rep)}


def _sharded_mamba(p: dict, x, cfg, axes: L.Axes, return_state: bool):
    """:func:`mamba_apply` on a mesh. JAX shards ``in_proj``'s output
    (z | x | B | C | dt, K = 2·d_inner + 2n + h) over the model axis and
    uses ``out_proj`` as ``(d_inner, None)``; K's shards do not line up
    with its parts (mamba2-370m: K = 4384 = 16·274, and shard 7 holds the
    end of z and the start of x). Here the heads split over the model axis
    when ``axes.tp(ssm_heads)`` allows it: each rank takes its heads' z,
    x and dt columns and the whole of B and C from ``in_proj`` used whole
    (its stored shards all-gathered, its gradient reduce-scattered back),
    runs the conv on its channels and the chunked scan on its heads, and
    its ``y`` is d_inner sharded over the model axis, the rows of
    ``out_proj``'s use layout ``(model, None)``. The gated RMSNorm over
    d_inner all-reduces each row's sum of squares ((B, S) floats); the
    out-projection's partial sums are all-reduced at the exit (``sc``).
    When the heads do not divide the model axis every model rank runs all
    heads, replicated. The batch stays sharded over the batch axes.

    ``return_state`` returns the cache as :func:`_state` lays it out; the
    caller lays it out as its cache."""
    mesh = L.mesh_of(x, p["in_proj"])
    x = L.sc(x, axes, axes.batch, None, None)
    bdims = L._shard_dims(x.placements, 0)
    m, tp, r = L.model_split(mesh, axes, cfg.ssm_heads)
    mdims = [] if m is None else [m]
    w = _local_weights(p, cfg, axes, m, tp, r, bdims + mdims, bdims)
    out, state = _mix(w, L.local(x, mdims), cfg, cfg.ssm_heads // tp,
                      _split_norm(cfg, mesh, m))
    out = L.from_local(out, mesh, L.with_placement(x.placements, m,
                                                   Partial()),
                       shape=x.shape)
    out = L.sc(out, axes, axes.batch, None, None)
    if not return_state:
        return out
    return out, _state(state, mesh, cfg, m, x.placements, x.shape[0])


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> dict:
    """The SSM state ``h`` in float32, the conv's left context in
    ``dtype``."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg, axes=None
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent update. x (B, 1, D) -> (out, new cache). Under
    a mesh it is :func:`_sharded_mamba_decode`."""
    if axes is not None:
        return _sharded_mamba_decode(p, x, cache, cfg, axes)
    return _step(p, x, cache, cfg, cfg.ssm_heads, _split_norm(cfg))


def _step(w: dict, x: torch.Tensor, cache: dict, cfg, hl: int, norm):
    """One decode step over ``hl`` heads on local tensors (``w`` and the
    cache's channels and heads as :func:`_mix` takes them)."""
    bsz = x.shape[0]
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    dl = hl * hp
    proj = torch.einsum("bsd,dk->bsk", x, w["in_proj"])
    z, xbc, dt = (proj[..., :dl], proj[..., dl:dl + dl + 2 * n],
                  proj[..., dl + dl + 2 * n:])
    xbc, conv_state = _causal_conv(xbc, w["conv_w"], w["conv_b"],
                                   state=cache["conv"])
    xs, b, c = xbc[..., :dl], xbc[..., dl:dl + n], xbc[..., dl + n:]
    dt = F.softplus(dt.float() + w["dt_bias"])[:, 0]                  # (B, H)
    a = torch.exp(dt * (-torch.exp(w["A_log"]))[None, :])             # (B, H)
    xh = xs[:, 0].reshape(bsz, hl, hp).float()
    bt = b[:, 0].float()                                              # (B, N)
    ct = c[:, 0].float()
    h_new = (cache["h"] * a[..., None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xh, bt, dt))
    y = torch.einsum("bn,bhpn->bhp", ct, h_new) + w["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, dl).to(x.dtype)
    y = norm(y * F.silu(z), w["norm_z"])
    out = torch.einsum("bsk,kd->bsd", y, w["out_proj"])
    return out, {"h": h_new, "conv": conv_state}


def _sharded_mamba_decode(p: dict, x, cache: dict, cfg, axes: L.Axes):
    """:func:`mamba_decode` on a mesh: the heads split over the model axis
    as in :func:`_sharded_mamba`, the whole batch on every rank (the
    caches of ``cache_pspecs`` are replicated over the batch axes; the
    one-token input is all-gathered instead). The conv cache (sharded
    over the model axis along its channels, whose shards do not line up
    with the heads) is all-gathered and each rank takes its heads' x
    channels and B, C; ``h`` (replicated) is sliced to its heads. The new
    ``h`` and conv's x channels are all-gathered over the model axis and
    laid out as the cache given."""
    mesh = L.mesh_of(x, cache["h"], p["in_proj"])
    x = L.sc(x, axes, None, None, None)
    rep = tuple([Replicate()] * mesh.ndim)
    m, tp, r = L.model_split(mesh, axes, cfg.ssm_heads)
    mdims = [] if m is None else [m]
    hl = cfg.ssm_heads // tp
    dl, di = hl * cfg.ssm_head_dim, cfg.d_inner
    w = _local_weights(p, cfg, axes, m, tp, r, mdims, [])
    cache = {k: L.replicate(v, mesh) for k, v in cache.items()}
    conv = cache["conv"].redistribute(mesh, rep).to_local()
    if m is not None:
        conv = torch.cat([conv[..., r * dl:(r + 1) * dl], conv[..., di:]],
                         dim=-1)
    h = cache["h"].redistribute(
        mesh, L.with_placement(rep, m, Shard(1))).to_local()
    out, state = _step(w, x.to_local(), {"h": h, "conv": conv}, cfg, hl,
                       _split_norm(cfg, mesh, m))
    out = L.from_local(out, mesh, L.with_placement(rep, m, Partial()),
                       shape=x.shape)
    out = L.sc(out, axes, axes.batch, None, None)
    new = _state(state, mesh, cfg, m, rep, x.shape[0])
    return out, {k: new[k].redistribute(mesh, cache[k].placements)
                 for k in new}
