"""Chunked flash attention, forward only — the port of
``repro.models.flash``'s forward (``_fwd``).

The online softmax over K/V chunks, with the (causal, window) mask, ``NEG``
for masked scores and ``o / max(l, 1e-30)`` at the end, in the same chunk
order as JAX's scan, so the sums run in the same order. Plain torch ops,
not ``scaled_dot_product_attention``: the function must be JAX's, masked
rows included. Serving needs no gradient; the recompute backward
(``flash.py:40-130``) becomes a ``torch.autograd.Function`` with the
training slice (``ROADMAP.md`` queue 1).

Shapes: q (B, Sq, KV, G, dh) grouped queries; k/v (B, Sk, KV, dh).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int], chunk: int,
                    scale: float) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` in ``q``'s dtype; scores, the
    running max and sum, and the output accumulate in float32."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    dev = q.device
    q32 = q.float()
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, sq, kvh, g), -torch.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, kvh, g, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        k_pos = c0 + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", q32, k_i) * scale
        ok = _mask(q_pos, k_pos, causal, window)
        s = torch.where(ok[None, :, None, None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, v_i)
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
