"""Chunked flash attention with a recompute backward — the port of
``repro.models.flash`` (its ``jax.custom_vjp``) as a
``torch.autograd.Function``.

The forward is the online softmax over K/V chunks, with the (causal,
window) mask, ``NEG`` for masked scores and ``o / max(l, 1e-30)`` at the
end, in the same chunk order as JAX's scan, so the sums run in the same
order. It saves only ``(q, k, v, out, lse)``, as JAX's ``_fwd_rule`` does:
autograd through the chunk loop would keep every chunk's (Sq × Ck)
probabilities, O(S²) memory. The backward is JAX's ``_bwd_rule``: ``delta
= Σ dO·O``, then per K/V chunk the masked scores are recomputed, ``p =
exp(s - lse)``, and ``dV_j``, ``dP``, ``dS = p·(dP - delta)·scale``, ``dQ``
(accumulated) and ``dK_j`` follow, all in float32; the grads come back in
the inputs' dtypes. Plain torch einsums, not
``scaled_dot_product_attention``: the function must be JAX's, masked rows
included. Under ``inference_mode`` (serving) the forward runs alone.

Shapes: q (B, Sq, KV, G, dh) grouped queries; k (B, Sk, KV, dh); v (B,
Sk, KV, dv), whose width may differ from the q·k width (latent
attention's 192 against 128). The queries sit at positions ``q0 + [0,
Sq)`` (``q0`` > 0 for one rank's slice of a sequence-sharded query,
``models/layers._sharded_flash``).
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


def _scores(q32, k_i, c0, chunk, q_pos, causal, window, scale):
    """The masked, scaled float32 scores of ``q`` against one K chunk
    starting at ``c0``: (B, Sq, KV, G, Ck)."""
    k_pos = c0 + torch.arange(chunk, device=q32.device)
    s = torch.einsum("bqkgd,bckd->bqkgc", q32, k_i) * scale
    ok = _mask(q_pos, k_pos, causal, window)
    return torch.where(ok[None, :, None, None, :], s, NEG)


def _fwd(q, k, v, causal, window, chunk, scale, q0=0):
    """(out in ``q``'s dtype, lse float32 (B, Sq, KV, G))."""
    b, sq, kvh, g, _ = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    dev = q.device
    q32 = q.float()
    q_pos = q0 + torch.arange(sq, device=dev)
    m = torch.full((b, sq, kvh, g), -torch.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, kvh, g, v.shape[-1]), dtype=torch.float32,
                    device=dev)
    for c0 in range(0, sk, chunk):
        v_i = v[:, c0:c0 + chunk].float()
        s = _scores(q32, k[:, c0:c0 + chunk].float(), c0, chunk, q_pos,
                    causal, window, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, v_i)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (o / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def _bwd(q, k, v, out, lse, dout, causal, window, chunk, scale, q0=0):
    """(dq, dk, dv) in the inputs' dtypes, GQA's G axis summed into dk and
    dv."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    q32 = q.float()
    q_pos = q0 + torch.arange(sq, device=q.device)
    do32 = dout.float()
    delta = (do32 * out.float()).sum(dim=-1)             # (b, sq, kvh, g)
    dq = torch.zeros((b, sq, kvh, g, dh), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for c0 in range(0, sk, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        s = _scores(q32, k_i, c0, chunk, q_pos, causal, window, scale)
        p = torch.exp(s - lse[..., None])                # (b, sq, kvh, g, ck)
        del s
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, do32))
        dp = torch.einsum("bqkgd,bckd->bqkgc", do32, v_i)
        ds = p * (dp - delta[..., None]) * scale
        del p, dp
        dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, k_i)
        dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, q32))
        del ds
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale, q0):
        out, lse = _fwd(q, k, v, causal, window, chunk, scale, q0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk, scale, q0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int], chunk: int,
                    scale: float, q0: int = 0) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` in ``q``'s dtype; scores, the
    running max and sum, the output and every gradient accumulate in
    float32. Differentiable in ``q``, ``k`` and ``v`` by the recompute
    backward."""
    return _Flash.apply(q, k, v, causal, window, chunk, scale, q0)
