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

from typing import Tuple

import torch
import torch.nn.functional as F

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


def _gates(p: dict, xb: torch.Tensor):
    """Per-step decay a_t and gated input, both float32."""
    x32 = xb.float()
    r = torch.sigmoid(torch.einsum("bsr,rk->bsk", x32, p["w_a"].float())
                      + p["b_a"])
    i = torch.sigmoid(torch.einsum("bsr,rk->bsk", x32, p["w_i"].float())
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
    :func:`rglru_decode`."""
    L.check_axes(axes)
    xb = torch.einsum("bsd,dr->bsr", x, p["wx"])
    xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                  return_state=True)
    a, gated = _gates(p, xb)
    h = linear_scan(a, gated)
    # jax.nn.gelu: the tanh form, whatever cfg.act says.
    gate = F.gelu(torch.einsum("bsd,dr->bsr", x, p["wg"]), approximate="tanh")
    proj = torch.einsum("bsr,rd->bsd", h.to(x.dtype) * gate, p["wo"])
    if return_state:
        return proj, {"h": h[:, -1], "conv": conv_state}
    return proj


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
    """One-token recurrent update. x (B, 1, D) -> (out, new cache)."""
    L.check_axes(axes)
    xb = torch.einsum("bsd,dr->bsr", x, p["wx"])
    xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    a, gated = _gates(p, xb)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    gate = F.gelu(torch.einsum("bsd,dr->bsr", x, p["wg"]), approximate="tanh")
    out = h[:, None, :].to(x.dtype) * gate
    return (torch.einsum("bsr,rd->bsd", out, p["wo"]),
            {"h": h, "conv": conv_state})
