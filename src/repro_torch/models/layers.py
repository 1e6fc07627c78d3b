"""Model building blocks on tensors — the port of ``repro.models.layers``:
norms, RoPE, GQA attention (chunked flash, sliding window, decode), MLPs,
embeddings.

Everything is functional: ``init_*`` returns param dicts drawn from an
explicit ``torch.Generator`` (on the generator's device), the apply
functions map (params, activations) -> activations and run where their
tensors lie. The JAX package's sharding hooks (``Axes``, ``sc``, ``uw``)
are not ported: one card holds the model whole, so every ``axes``
argument must be ``None``. Context-parallel decode (``_cp_decode_attend``)
waits for the sharding slice (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.flash import flash_attention


def check_axes(axes) -> None:
    """The port runs unsharded on one card: ``axes`` must be ``None``."""
    if axes is not None:
        raise NotImplementedError(
            "sharding axes are not ported: repro_torch runs a model whole "
            "on one card (axes=None); sharding is ROADMAP.md queue 1 item 3")


# ------------------------------------------------------------------- utils
def dense_init(gen: torch.Generator, in_dim: int, out_dims,
               dtype: torch.dtype) -> torch.Tensor:
    shape = ((in_dim, *out_dims) if isinstance(out_dims, tuple)
             else (in_dim, out_dims))
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., d_head/2)."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, dh); cos/sin (..., S, dh/2) broadcast over heads. The
    tables are cast to ``x``'s dtype before the products, as JAX does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------- attention
def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, d, (h, dh), dtype),
        "wk": dense_init(gen, d, (kv, dh), dtype),
        "wv": dense_init(gen, d, (kv, dh), dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((heads, dh), dtype=dtype,
                                  device=gen.device)
    return p


def qkv_project(p: dict, x: torch.Tensor, cfg, axes=None):
    """x (B, S, D) -> q (B, S, H, dh), k/v (B, S, KV, dh)."""
    check_axes(axes)
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _pick_chunk(sk: int, want: int) -> Optional[int]:
    """Largest power-of-two-ish divisor of sk ≤ want (flash needs even
    chunking); None if sk has no usable divisor."""
    c = min(want, sk)
    while c > 1 and sk % c:
        c //= 2
    return c if sk % c == 0 else None


def attention(
    p: dict,
    x: torch.Tensor,
    cfg,
    axes=None,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Multi-head GQA attention over a full sequence (train / prefill).

    ``window`` enables sliding-window masking (local layers);
    ``kv_override`` supplies external K/V (cross-attention) — no RoPE is
    applied to overridden KV and causality is disabled. Both of JAX's
    ``attn_impl`` values compute one function, the chunked online softmax;
    the port runs :func:`repro_torch.models.flash.flash_attention` for
    both, at JAX's ``flash_vjp`` chunking.
    """
    check_axes(axes)
    b, s, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = qkv_project(p, x, cfg)
    if kv_override is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv_override
        causal = False
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    chunk = _pick_chunk(k.shape[1], cfg.attn_chunk)
    o = flash_attention(qg, k, v, causal, window, chunk,
                        1.0 / math.sqrt(dh)).float()
    o = o.reshape(b, s, h, dh).to(x.dtype)
    wo = p["wo"].reshape(h, dh, d)
    return torch.einsum("bshe,hed->bsd", o, wo)


def decode_attention(
    p: dict,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    cfg,
    axes=None,
    *,
    window: Optional[int] = None,
    cross: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache.

    x (B, 1, D); caches (B, S_max, KV, dh); pos (B,) current positions.
    Returns (out, new_k_cache, new_v_cache); the caches given are not
    written. ``cross=True`` (enc-dec) reads the whole prefilled encoder
    cache: no K/V write, no RoPE, and every row attended (an empty cache
    gives zeros).
    """
    check_axes(axes)
    b, _, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_max = k_cache.shape[1]
    if cross:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
    else:
        q, k, v = qkv_project(p, x, cfg)
        cos, sin = rope_angles(pos[:, None], dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = _cache_insert(k_cache, k, pos)
        v_cache = _cache_insert(v_cache, v, pos)
    qg = q.reshape(b, kvh, h // kvh, dh)
    attend_pos = torch.full_like(pos, s_max) if cross else pos
    out = _decode_attend(qg, k_cache, v_cache, attend_pos, window, dh,
                         torch.arange(s_max, device=x.device))
    o = out.reshape(b, 1, h * dh).to(x.dtype)
    return (torch.einsum("bsf,fd->bsd", o, p["wo"].reshape(h * dh, d)),
            k_cache, v_cache)


def _cache_insert(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor):
    """A copy of ``cache`` with (B, 1, KV, dh) written at per-batch
    position ``pos`` (B,). JAX's dynamic-update-slice clamps a position
    past the end; here the caller checks ``pos < S_max``
    (:func:`repro_torch.models.transformer.decode_step`), and an index
    past the end raises rather than landing on the last row."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((rows, pos.long()), kv[:, 0].to(cache.dtype))


def _decode_attend(qg, k_cache, v_cache, pos, window, dh, k_positions):
    """qg (B, KV, G, dh) vs cache (B, S, KV, dh) -> (B, KV, G, dh)."""
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float() * scale, k_cache.float())
    valid = k_positions[None, :] <= pos[:, None]
    if window is not None:
        valid &= k_positions[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p_ = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p_, v_cache.float())


# -------------------------------------------------------------------- MLP
def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """JAX's ``jax.nn.gelu`` defaults to the tanh form; torch's to erf."""
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    return F.silu(h)


def init_mlp(gen: torch.Generator, cfg, dtype,
             d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {
            "wi": dense_init(gen, d, f, dtype),
            "wg": dense_init(gen, d, f, dtype),
            "wo": dense_init(gen, f, d, dtype),
        }
    return {
        "wi": dense_init(gen, d, f, dtype),
        "wo": dense_init(gen, f, d, dtype),
    }


def mlp(p: dict, x: torch.Tensor, cfg, axes=None) -> torch.Tensor:
    check_axes(axes)
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.act == "silu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = F.silu(g) * h
    else:
        h = activation(h, cfg.act)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# -------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg, dtype) -> dict:
    p = {"tok": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=gen.device) * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def embed(p: dict, tokens: torch.Tensor, cfg, axes=None) -> torch.Tensor:
    """Rows of the table times sqrt(d_model), in the table's dtype."""
    check_axes(axes)
    return p["tok"][tokens] * math.sqrt(cfg.d_model)


def logits(p: dict, x: torch.Tensor, cfg, axes=None) -> torch.Tensor:
    check_axes(axes)
    table = p["tok"] if cfg.tie_embeddings else p["head"].T
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))
