"""Multi-head latent attention (MLA), DeepSeek-V2's attention, with its
YaRN position scaling: the layer kind ``"mla"``. The JAX package has no
counterpart.

A token's hidden state ``x`` gives the queries, ``q = x W_q``: ``n_heads``
heads of ``qk_nope_head_dim + qk_rope_head_dim``, split into a part without
position ("nope") and a part rotated by position ("rope"). It also gives
``[c | k_pe] = x W_kva``: the latent ``c`` of ``kv_lora_rank``, RMS-normed
with its own scale, and one rotated key ``k_pe`` of ``qk_rope_head_dim``
shared by every head. ``W_kvb`` maps ``c`` to each head's key part
(``W_UK``, ``qk_nope_head_dim``) and value (``W_UV``, ``v_head_dim``).
Scores are ``q_nope·k_nope + q_pe·k_pe`` at YaRN's softmax scale; the
heads' values go through ``W_o``.

* Prefill and the forward (:func:`mla_attention`) run the expanded form:
  per-head keys and values from ``c``, through
  :func:`repro_torch.models.flash.flash_attention` with a q·k width of
  ``qk_nope + qk_rope`` and a value width of ``v_head_dim``.
* Decode (:func:`mla_decode`) runs the absorbed form against the latent
  cache, which holds ``c`` (normed) and ``k_pe`` (rotated) a position and
  no per-head key or value: a head scores ``(q_nope W_UK,h)·c + q_pe·k_pe``
  and takes ``o_h = (Σ p c) W_UV,h``. On the card the scores, softmax and
  ``Σ p c`` are one kernel (:mod:`repro_torch.kernels.mla_decode`) that
  reads each row's valid positions once; on the CPU they are plain
  tensor code, the reference. The rope tables of a step's positions
  (:func:`decode_tables`) are made once for all its layers: every layer
  launches fewer small kernels from the host.

RoPE rotates half-split pairs, as the port's other layers do (DeepSeek-V2
rotates interleaved pairs: the same map under a fixed permutation of the
rope columns of ``W_q`` and ``W_kva``). Spans: ``repro.mla.prefill``
around the expanded path, ``repro.mla.decode`` around a layer's absorbed
attention and its cache insert; the counter ``repro.mla.positions``
counts the latent positions a decode step attends in each layer, and
``repro.mla.attend_launches`` the kernel's launches a step issues
(:func:`count_launches`).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.models import layers as L
from repro_torch.models.flash import flash_attention
from repro_torch.obs import trace


def init_mla(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": L.dense_init(gen, d, (h, nope + rope), dtype),
        "wkv_a": L.dense_init(gen, d, r + rope, dtype),
        "kv_norm": L.rmsnorm_init(r, dtype, gen.device),
        "wkv_b": L.dense_init(gen, r, (h, nope + dv), dtype),
        "wo": L.dense_init(gen, h * dv, d, dtype),
    }


# ------------------------------------------------------------------- YaRN
#: DeepSeek-V2's published ``rope_scaling``: the ramp's ends in rotations
#: (``beta_fast``, ``beta_slow``) and ``mscale`` = ``mscale_all_dim``, so
#: the cos and sin tables keep their scale of 1 and only the softmax
#: scale takes the factor.
BETA_FAST, BETA_SLOW, MSCALE = 32.0, 1.0, 0.707


def _yarn_mscale(scale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * MSCALE * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    length: int) -> float:
    return (dim * math.log(length / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_range(cfg) -> Tuple[int, int]:
    """DeepSeek-V2's ``yarn_find_correction_range``: the first and last
    rotary pair of the ramp from extrapolated to interpolated
    frequencies."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    low = math.floor(_correction_dim(BETA_FAST, dim, base,
                                     cfg.yarn_original_len))
    high = math.ceil(_correction_dim(BETA_SLOW, dim, base,
                                     cfg.yarn_original_len))
    return max(low, 0), min(high, dim - 1)


def inv_freq(cfg, device=None) -> torch.Tensor:
    """The rotary pairs' inverse frequencies, float32 (rope/2,): the plain
    ``theta^(-2i/rope)``, or with YaRN the linear ramp between those
    (``freq_extra``) and those divided by the factor (``freq_inter``)."""
    dim = cfg.qk_rope_head_dim
    extra = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if not cfg.yarn_factor:
        return extra
    inter = extra / cfg.yarn_factor
    low, high = yarn_range(cfg)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low if high != low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg) -> float:
    """``(qk_nope + qk_rope)^-0.5``, times ``mscale(factor)^2`` with
    YaRN."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor:
        scale *= _yarn_mscale(cfg.yarn_factor) ** 2
    return scale


def rope_tables(positions: torch.Tensor, cfg, dtype=torch.float32):
    """positions (B or 1, S) -> the tables :func:`_rope` takes, (cos,
    cos) and (-sin, sin) side by side, (B or 1, S, 1, rope): computed in
    float32 and given in ``dtype``, the activations'."""
    ang = positions.float()[..., None] * inv_freq(cfg, positions.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[..., None, :].to(dtype),
            torch.cat([-sin, sin], -1)[..., None, :].to(dtype))


def _rope(x: torch.Tensor, cos2: torch.Tensor, sin2: torch.Tensor):
    """x (B, S, H, rope) rotated by half-split pairs, as
    ``layers.apply_rope`` rotates them (the same products and sums), from
    :func:`rope_tables`' tables."""
    half = x.shape[-1] // 2
    return x * cos2 + torch.cat([x[..., half:], x[..., :half]], -1) * sin2


class DecodeTables(NamedTuple):
    """What every latent-attention layer of one decode step shares: the
    rope tables at each row's position (:func:`rope_tables`)."""

    cos2: torch.Tensor
    sin2: torch.Tensor


def decode_tables(pos: torch.Tensor, cfg, dtype) -> DecodeTables:
    """The step's :class:`DecodeTables`, once for all its layers."""
    return DecodeTables(*rope_tables(pos[:, None], cfg, dtype))


# -------------------------------------------------------------- projections
def _project(p: dict, x: torch.Tensor, cfg, cos2: torch.Tensor,
             sin2: torch.Tensor):
    """x (B, S, D) with the rope tables of its positions -> q_nope (B, S,
    H, nope), q_pe (B, S, H, rope) rotated, c (B, S, r) normed, k_pe (B,
    S, rope) rotated; in ``x``'s dtype."""
    b, s, d = x.shape
    h, r, nope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = torch.matmul(x, p["wq"].reshape(d, -1)).view(b, s, h, -1)
    kva = torch.matmul(x, p["wkv_a"])
    # layers.rmsnorm's float32 norm, fused into one op.
    c = F.rms_norm(kva[..., :r].float(), (r,), p["kv_norm"].float(),
                   cfg.norm_eps).to(x.dtype)
    # The heads' rope parts and the shared rope key rotated together.
    pe = _rope(torch.cat([q[..., nope:], kva[..., None, r:]], dim=2), cos2,
               sin2)
    return q[..., :nope], pe[:, :, :h], c, pe[:, :, h]


def mla_attention(p: dict, x: torch.Tensor, cfg,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over a full sequence (train / prefill), the expanded
    form: x (B, S, D) -> (out (B, S, D), c (B, S, r), k_pe (B, S, rope)),
    the last two what the decode cache keeps of each position."""
    with trace.TRACE.span("repro.mla.prefill"):
        b, s, _ = x.shape
        h, nope, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q_nope, q_pe, c, k_pe = _project(
            p, x, cfg, *rope_tables(positions, cfg, x.dtype))
        kv = torch.einsum("bsc,che->bshe", c, p["wkv_b"])
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None, :].expand(b, s, h, -1)], dim=-1)
        o = flash_attention(q.reshape(b, s, h, 1, -1), k, kv[..., nope:],
                            True, None, L._pick_chunk(s, cfg.attn_chunk),
                            softmax_scale(cfg))
        o = o.reshape(b, s, h * dv).to(x.dtype)
        return torch.matmul(o, p["wo"]), c, k_pe


def latent_attend_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                        c_cache: torch.Tensor, pe_cache: torch.Tensor,
                        pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain scores, softmax and weighted sum of latents, float32:
    q_lat (B, H, r), q_pe (B, H, rope), the caches, row b attending keys
    ``[0, pos[b]]`` -> o_lat (B, H, r), ``Σ p c``; every slot widened and
    scored, then masked. What :func:`absorbed_attend` runs on the CPU, and
    the kernel's reference on the card."""
    valid = (torch.arange(c_cache.shape[1], device=pos.device)
             <= pos[:, None])[:, None]
    c32 = c_cache.float()
    s = torch.baddbmm(torch.bmm(q_lat, c32.transpose(1, 2)), q_pe.float(),
                      pe_cache.float().transpose(1, 2), beta=scale,
                      alpha=scale)
    p_ = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    return torch.bmm(p_, c32)


def absorbed_attend(q_nope: torch.Tensor, q_pe: torch.Tensor,
                    wkv_b: torch.Tensor, c_cache: torch.Tensor,
                    pe_cache: torch.Tensor, pos: torch.Tensor, cfg
                    ) -> torch.Tensor:
    """One query a row against the latent cache, float32: q_nope (B, H,
    nope), q_pe (B, H, rope), caches (B, S_max, r) and (B, S_max, rope),
    row b attending keys ``[0, pos[b]]`` (pos (B,)) -> the heads' values
    (B, H, dv). ``W_UK`` and ``W_UV`` are batched matmuls over the heads.
    The scores, softmax and ``Σ p c``: on a CUDA tensor the kernel
    :func:`repro_torch.kernels.mla_decode.mla_attend` (``pos`` int32; it
    raises on what it does not take); on the CPU
    :func:`latent_attend_plain`."""
    nope = cfg.qk_nope_head_dim
    scale = softmax_scale(cfg)
    w = wkv_b.float().transpose(0, 1)                   # (H, r, nope + dv)
    q_lat = torch.matmul(q_nope.float().transpose(0, 1),
                         w[..., :nope].transpose(1, 2)).transpose(0, 1)
    if c_cache.is_cuda:
        o_lat = mla_kernel.mla_attend(q_lat, q_pe.float(), c_cache,
                                      pe_cache, pos, scale)
    else:
        o_lat = latent_attend_plain(q_lat, q_pe, c_cache, pe_cache, pos,
                                    scale)
    return torch.matmul(o_lat.transpose(0, 1),
                        w[..., nope:]).transpose(0, 1)


def mla_decode(p: dict, x: torch.Tensor, c_cache: torch.Tensor,
               pe_cache: torch.Tensor, pos: torch.Tensor, cfg,
               tables: DecodeTables, in_place: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token MLA against the latent cache, the absorbed form: x (B, 1,
    D), caches (B, S_max, r) and (B, S_max, rope), pos (B,) and the step's
    :func:`decode_tables` -> (out (B, 1, D), new c cache, new k_pe cache),
    this token's ``c`` and ``k_pe`` written at ``pos``: into copies, the
    caches given not written, or into the caches given (``in_place``),
    which are returned."""
    with trace.TRACE.span("repro.mla.decode"):
        b = x.shape[0]
        q_nope, q_pe, c, k_pe = _project(p, x, cfg, tables.cos2,
                                         tables.sin2)
        c_cache = L._cache_insert(c_cache, c, pos, in_place)
        pe_cache = L._cache_insert(pe_cache, k_pe, pos, in_place)
        o = absorbed_attend(q_nope[:, 0], q_pe[:, 0], p["wkv_b"], c_cache,
                            pe_cache, pos, cfg)
        o = o.reshape(b, 1, -1).to(x.dtype)
        return torch.matmul(o, p["wo"]), c_cache, pe_cache


def count_positions(at: List[int]) -> None:
    """With tracing on or a profiler recording, the counter
    ``repro.mla.positions``: the latent positions a decode step attends in
    each layer, Σ (pos + 1) over its rows, from the positions the step's
    bound check read to the host."""
    if trace.recording():
        trace.TRACE.counter("repro.mla.positions", sum(at) + len(at),
                            pid=trace.PID_HOST)


def count_launches(n: int) -> None:
    """With tracing on or a profiler recording, the counter
    ``repro.mla.attend_launches``: the absorbed-attention kernel's
    launches that one decode step issues (``serve.engine.GraphedDecode``
    counts them in the step it captures; 0 on the CPU)."""
    if trace.recording():
        trace.TRACE.counter("repro.mla.attend_launches", n,
                            pid=trace.PID_HOST)
