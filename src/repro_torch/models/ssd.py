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

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:di + di + 2 * n],
            proj[..., di + di + 2 * n:])


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
    smaller chunks)."""
    if axes is not None:
        L.check_unsharded(axes, "the SSD mixer", x)
        return L.on_local(mamba_apply, axes, p, x, cfg,
                          return_state=return_state)
    bsz, s, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   return_state=True)
    xs, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a_head = -torch.exp(p["A_log"])
    xh = xs.reshape(bsz, s, h, cfg.ssm_head_dim)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s)
    y, h_last = ssd_chunked(xh, dt, a_head, b, c, chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm_z"], cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    if return_state:
        return out, {"h": h_last, "conv": conv_state}
    return out


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
    """One-token recurrent update. x (B, 1, D) -> (out, new cache)."""
    if axes is not None:
        L.check_unsharded(axes, "the SSD decode", x)
        return L.on_local(mamba_decode, axes, p, x, cache, cfg)
    bsz = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    xs, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                  # (B, H)
    a = torch.exp(dt * (-torch.exp(p["A_log"]))[None, :])             # (B, H)
    xh = xs[:, 0].reshape(bsz, h, cfg.ssm_head_dim).float()
    bt = b[:, 0].float()                                              # (B, N)
    ct = c[:, 0].float()
    h_new = (cache["h"] * a[..., None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xh, bt, dt))
    y = torch.einsum("bn,bhpn->bhp", ct, h_new) + p["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm_z"], cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, {"h": h_new, "conv": conv_state}
