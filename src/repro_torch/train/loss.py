"""Sequence-chunked softmax cross-entropy — the port of
``repro.train.loss``.

gemma3's 262k vocab makes full (B, S, V) logits 2 GB/device at train_4k;
chunking the sequence bounds the live logits to (B, chunk, V). Each chunk
runs under ``torch.utils.checkpoint`` (``jax.checkpoint`` in JAX), so its
logits are recomputed in backward instead of being kept: the full (B, S,
V) logits never exist.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(h, lab, logits_fn):
    """(Σ masked NLL, Σ mask) of one chunk, in float32."""
    logits = logits_fn(h).to(torch.float32)              # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lab.clamp_min(0)[..., None].long())
    nll = lse - picked[..., 0]
    mask = (lab >= 0).to(torch.float32)
    return (nll * mask).sum(), mask.sum()


def xent_chunked(
    hidden: torch.Tensor,          # (B, S, D) final hidden states
    labels: torch.Tensor,          # (B, S) int; -1 = masked
    logits_fn: Callable[[torch.Tensor], torch.Tensor],  # (B, C, D)->(B, C, V)
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean masked token NLL + the count of unmasked labels, never
    materialising (B, S, V). Chunk sums add in sequence order, as JAX's
    scan does."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    body = _chunk_nll
    if torch.is_grad_enabled():
        body = lambda h, lab, fn: checkpoint(  # noqa: E731
            _chunk_nll, h, lab, fn, use_reentrant=False)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, n_chunks * chunk, chunk):
        t, c = body(hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                    logits_fn)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0), cnt


def full_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unchunked reference (tests)."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(lp, -1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return -(picked * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
