"""Gradient compression with error feedback — the port of
``repro.optim.compress``: applied before the pod-axis (DCN) all-reduce
where bandwidth is scarcest (one card has none yet; the train step runs it
all the same when asked).

* int8 symmetric quantisation (per-leaf scale), rounding half to even as
  ``jnp.round`` does, or
* top-k magnitude sparsification (static k per leaf), keeping every entry
  tied with the k-th largest magnitude (``>=``, as JAX),

both with error-feedback residual accumulation so compression noise is
unbiased over steps (Karimireddy et al., 2019 style).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.common.pytree import tree_map, tree_map_n


@dataclasses.dataclass(frozen=True)
class Compressor:
    kind: str = "int8"        # int8 | topk | none
    topk_ratio: float = 0.05  # fraction of entries kept for topk


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_roundtrip(g: torch.Tensor, ratio: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat, 0.0)
    return kept.reshape(g.shape)


def compress_with_feedback(comp: Compressor, grads, error) -> Tuple:
    """(compressed grads to all-reduce, new error residual)."""
    if comp.kind == "none":
        return grads, error

    def one(g, e):
        g32 = g.to(torch.float32) + e
        if comp.kind == "int8":
            sent = _int8_roundtrip(g32)
        elif comp.kind == "topk":
            sent = _topk_roundtrip(g32, comp.topk_ratio)
        else:
            raise ValueError(comp.kind)
        return sent.to(g.dtype), g32 - sent

    return tree_map_n(one, 2, grads, error)
