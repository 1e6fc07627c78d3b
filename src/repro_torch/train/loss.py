"""Sequence-chunked softmax cross-entropy — the port of
``repro.train.loss``.

gemma3's 262k vocab makes full (B, S, V) logits 2 GB/device at train_4k;
chunking the sequence bounds the live logits to (B, chunk, V). Each chunk
runs under ``torch.utils.checkpoint`` (``jax.checkpoint`` in JAX), so its
logits are recomputed in backward instead of being kept: the full (B, S,
V) logits never exist.

Under a mesh the logits are a DTensor, rows sharded over the batch axes
and the vocab over the model axis. DTensor's ``logsumexp`` all-gathers a
vocab-sharded row, so :func:`_chunk_nll_sharded` reduces explicitly on
each rank's slice: the row max by a max all-reduce over the vocab's mesh
dims, the sum of exponentials and the picked logit (zero outside a rank's
vocab range) as partial sums made whole by DTensor's all-reduce.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint


def _chunk_nll(h, lab, logits_fn):
    """(Σ masked NLL, Σ mask) of one chunk, in float32."""
    logits = logits_fn(h).to(torch.float32)              # (B, C, V)
    if isinstance(logits, DTensor):
        return _chunk_nll_sharded(logits, lab)
    return _chunk_nll_local(logits, lab)


def _chunk_nll_sharded(logits: DTensor, lab):
    """:func:`_chunk_nll` of DTensor logits (B, C, V): sums over each
    rank's rows and vocab slice, returned as DTensor scalars (partial over
    the batch axes)."""
    mesh, pl = logits.device_mesh, logits.placements
    if any(p.is_partial() or (p.is_shard() and p.dim not in (0, 2))
           for p in pl):
        raise ValueError(f"logits placed {pl}: want rows (dim 0) and vocab "
                         "(dim 2) shards only")
    vdims = [i for i, p in enumerate(pl) if p.is_shard() and p.dim == 2]
    rows = [Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
            for p in pl]
    lg = logits.to_local()
    if not isinstance(lab, DTensor):
        lab = DTensor.from_local(lab, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    lab = lab.redistribute(mesh, rows).to_local().long()
    if not vdims:                           # each rank's rows whole
        t, c = _chunk_nll_local(lg, lab)
    else:
        t, c = _chunk_nll_vocab(lg, lab, mesh, rows, vdims)
    sums = [Partial() if r.is_shard() else Replicate() for r in rows]
    return (DTensor.from_local(t, mesh, sums, run_check=False),
            DTensor.from_local(c, mesh, sums, run_check=False))


def _chunk_nll_local(logits, lab):
    """(Σ masked NLL, Σ mask) of float32 logits (B, C, V), whole rows."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lab.clamp_min(0)[..., None].long())
    nll = lse - picked[..., 0]
    mask = (lab >= 0).to(torch.float32)
    return (nll * mask).sum(), mask.sum()


def _chunk_nll_vocab(lg, lab, mesh, rows, vdims):
    """The same sums from one rank's vocab slice of each row."""
    from torch.distributed import _functional_collectives as funcol

    v_loc = lg.shape[-1]
    block = 0
    for i in vdims:                         # major mesh dim first
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    m = lg.detach().amax(dim=-1)
    for i in vdims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    idx = lab.clamp_min(0) - block * v_loc
    inside = (idx >= 0) & (idx < v_loc)
    picked = torch.gather(lg, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = picked * inside
    part = [Partial() if i in vdims else r for i, r in enumerate(rows)]
    se = DTensor.from_local(se, mesh, part, run_check=False
                            ).redistribute(mesh, rows).to_local()
    picked = DTensor.from_local(picked, mesh, part, run_check=False
                                ).redistribute(mesh, rows).to_local()
    nll = m + torch.log(se) - picked
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
    tot = cnt = None
    for c0 in range(0, n_chunks * chunk, chunk):
        t, c = body(hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                    logits_fn)
        tot, cnt = (t, c) if tot is None else (tot + t, cnt + c)
    return tot / torch.clamp_min(cnt, 1.0), cnt


def full_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unchunked reference (tests)."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(lp, -1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return -(picked * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
