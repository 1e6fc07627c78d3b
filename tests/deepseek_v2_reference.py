"""A plain float32 forward of DeepSeek-V2 (latent attention, YaRN, a
leading dense layer, a softmax router with unrenormalised top-k shares,
shared experts) for the port's tests: no cache, no capacity, no batching,
TF32 off. It imports nothing of the port or of JAX; it reads the weights
in the tree the port takes them (``lead``, ``blocks/s0`` stacked,
``embed/tok`` and ``embed/head``) and the model's sizes as a dict
(``dataclasses.asdict`` of a ``ModelConfig``).

It follows DeepSeek-V2's published description with the port's
departures: RoPE on half-split pairs (DeepSeek-V2 rotates interleaved
pairs, the same map under a fixed permutation of the rope columns), the
embedding scaled by sqrt(d_model). The benchmark's copy,
``portbench/references/deepseek_v2_f32.py``, computes the same forward in
blocks of queries and judges a run's outputs with it."""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


#: DeepSeek-V2's published ``rope_scaling`` beside its factor and
#: original length (config.json): the ramp's ends in rotations and the
#: two mscale values.
BETA_FAST, BETA_SLOW, MSCALE, MSCALE_ALL_DIM = 32.0, 1.0, 0.707, 0.707


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_range(low_rot, high_rot, dim, base, length):
    """DeepSeek-V2's ``yarn_find_correction_range``."""
    def dim_of(rot):
        return (dim * math.log(length / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    return (max(math.floor(dim_of(low_rot)), 0),
            min(math.ceil(dim_of(high_rot)), dim - 1))


def inv_freq(m: Dict) -> torch.Tensor:
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` inverse
    frequencies (the plain ones without YaRN)."""
    dim, base = m["qk_rope_head_dim"], m["rope_theta"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2).float() / dim))
    if not m["yarn_factor"]:
        return freq_extra
    freq_inter = 1.0 / (m["yarn_factor"]
                        * base ** (torch.arange(0, dim, 2).float() / dim))
    low, high = yarn_find_correction_range(
        BETA_FAST, BETA_SLOW, dim, base, m["yarn_original_len"])
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def softmax_scale(m: Dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    if m["yarn_factor"]:
        scale *= yarn_get_mscale(m["yarn_factor"], MSCALE_ALL_DIM) ** 2
    return scale


def rope(x: torch.Tensor, m: Dict) -> torch.Tensor:
    """x (B, L, ..., rope) rotated at positions 0..L-1, half-split
    pairs."""
    b, n, half = x.shape[0], x.shape[1], x.shape[-1] // 2
    ang = torch.arange(n).float()[:, None] * inv_freq(m)
    k = 1.0
    if m["yarn_factor"]:
        k = (yarn_get_mscale(m["yarn_factor"], MSCALE)
             / yarn_get_mscale(m["yarn_factor"], MSCALE_ALL_DIM))
    shape = (1, n) + (1,) * (x.dim() - 3) + (half,)
    c = (torch.cos(ang) * k).reshape(shape)
    s = (torch.sin(ang) * k).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mla(h: torch.Tensor, w: Dict, m: Dict
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal latent attention, expanded, over h (B, L, D): the output and
    the latent cached at each position, (B, L, kv_lora_rank + qk_rope)."""
    b, n, d = h.shape
    heads, r = m["n_heads"], m["kv_lora_rank"]
    nope, dv = m["qk_nope_head_dim"], m["v_head_dim"]
    q = torch.einsum("bld,dhe->blhe", h, w["wq"])
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], m)
    kva = h @ w["wkv_a"]
    c = rmsnorm(kva[..., :r], w["kv_norm"], m["norm_eps"])
    k_pe = rope(kva[..., r:], m)
    kv = torch.einsum("blc,che->blhe", c, w["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhr,bkr->bhqk", q_pe, k_pe)) * softmax_scale(m)
    future = torch.ones(n, n, dtype=torch.bool).triu(1)
    p = torch.softmax(s.masked_fill(future, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, heads * dv)
    return o @ w["wo"], torch.cat([c, k_pe], dim=-1)


def swiglu(x, w):
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


def moe(h: torch.Tensor, w: Dict, m: Dict) -> torch.Tensor:
    """Softmax over all E router logits, top k kept unrenormalised
    (``routed_scaling_factor`` is 1), every token to its k experts (no
    capacity), plus the shared experts."""
    probs = torch.softmax(h @ w["router"], dim=-1)
    share, idx = torch.topk(probs, m["experts_per_token"], dim=-1)
    out = torch.zeros_like(h)
    for e in range(m["n_experts"]):
        sel = (idx == e).float() * share               # (..., k)
        gate = sel.sum(-1, keepdim=True)
        if not bool((gate > 0).any()):
            continue
        y = (F.silu(h @ w["wg"][e]) * (h @ w["wi"][e])) @ w["wo"][e]
        out = out + gate * y
    return out + swiglu(h, w["shared"])


def layers(weights: Dict):
    """Each layer's float32 weights in order: leading blocks, then the
    stacked ones."""
    def f32(t, i=None):
        if isinstance(t, dict):
            return {k: f32(v, i) for k, v in t.items()}
        return (t if i is None else t[i]).float()

    for block in weights.get("lead", ()):
        yield f32(block)
    s0 = weights["blocks"]["s0"]
    for i in range(s0["norm1"].shape[0]):
        yield f32(s0, i)


def forward(weights: Dict, tokens: torch.Tensor, m: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, L) -> (logits (B, L, vocab_size) float32, latents
    (layers, B, L, kv_lora_rank + qk_rope))."""
    eps = m["norm_eps"]
    with torch.no_grad(), no_tf32():
        x = (weights["embed"]["tok"][tokens.long()].float()
             * math.sqrt(m["d_model"]))
        lats = []
        for w in layers(weights):
            o, lat = mla(rmsnorm(x, w["norm1"], eps), w["attn"], m)
            x = x + o
            lats.append(lat)
            h2 = rmsnorm(x, w["norm2"], eps)
            x = x + (moe(h2, w["ffn"], m) if "router" in w["ffn"]
                     else swiglu(h2, w["ffn"]))
        x = rmsnorm(x, weights["final_norm"].float(), eps)
        head = weights["embed"]["head"].float()[:, :m["vocab_size"]]
        return x @ head, torch.stack(lats)
