"""The work of one decode step of a language model and the least time the
card could take for it, counted from the model's own weight and cache
trees (``abstract_params`` and ``init_cache`` on the ``meta`` device,
which allocate nothing), so that another architecture needs no formula
of its own.

A step feeds one token to each row at its own position. Its operations
are twice the weights each token multiplies through (every matrix but
the token table, which is looked up; of the experts' matrices
``experts_per_token`` of ``n_experts``; the output head, the tied table
where there is no other) plus attention, ``4 * n_heads * d_head``
operations a key and attention layer, over each row's keys and its own.
Its bytes are the weights it reads, once each (every expert: at tens of
rows a step every expert of a layer is all but surely picked; of an
untied token table only the rows looked up), each key and value already
in the cache read once, one key and one value written a row and layer,
and the logits written once. The vocabulary counts as
``vocab_size``: the rows the port pads its tables with are never read
as real. Peaks as in ``portbench.work``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from portbench import lm_inputs
from portbench.operands import DTYPES
from portbench.work import PEAK_BYTES, PEAK_FLOPS


@dataclass(frozen=True)
class StepWork:
    flops: int
    nbytes: int


@dataclass(frozen=True)
class Counts:
    """What a step's work is made of, for one model."""

    weight_bytes: int       # every weight once, the vocabulary unpadded
    table_row_bytes: int    # a row of an untied token table (else 0)
    token_params: int       # the weights one token multiplies through
    attn_layers: int        # layers that attend over a cache
    kv_bytes: int           # one position's keys and values, every layer


def counts(model: Dict, cache_dtype: str) -> Counts:
    from repro_torch.common.pytree import tree_leaves_with_path
    from repro_torch.models import zoo
    from repro_torch.models.config import ModelConfig

    built = zoo.build(ModelConfig(**model))
    v, vp = int(model["vocab_size"]), built.padded_vocab
    share = (int(model["experts_per_token"]) / int(model["n_experts"])
             if int(model.get("n_experts", 0)) else 1.0)
    weight_bytes = table_row_bytes = token_params = 0
    for path, leaf in tree_leaves_with_path(built.abstract_params()):
        n = leaf.numel()
        if path[0] == "embed":          # (V padded, D) or (D, V padded)
            n = n // vp * v
        weight_bytes += n * leaf.element_size()
        shape = lm_inputs.matrix_shape(path, leaf)
        if path[-1] == "tok":
            if model["tie_embeddings"]:
                token_params += n       # the head
            else:
                table_row_bytes = leaf.shape[-1] * leaf.element_size()
        elif len(shape) > 1:
            token_params += (n * share if lm_inputs.is_expert(model, shape)
                             else n)
    cache = built.init_cache(1, 1, dtype=DTYPES[cache_dtype], device="meta")
    kv = [leaf for path, leaf in tree_leaves_with_path(cache)
          if path[-1] in ("k", "v")]
    # A (layers, 1 row, 1 position, kv heads, d_head) leaf each of K, V.
    attn_layers = sum(leaf.numel() // (leaf.shape[-1] * leaf.shape[-2])
                      for leaf in kv) // 2
    kv_bytes = sum(leaf.numel() * leaf.element_size() for leaf in kv)
    return Counts(weight_bytes, table_row_bytes, int(token_params),
                  attn_layers, kv_bytes)


def step_work(model: Dict, positions: Sequence[int],
              cache_dtype: str = "bfloat16",
              c: Optional[Counts] = None) -> StepWork:
    """One step of ``len(positions)`` rows, row b feeding its token at
    position ``positions[b]`` (so ``positions[b]`` keys before it);
    ``c``, the model's counts where already taken."""
    c = c or counts(model, cache_dtype)
    rows = len(positions)
    keys = sum(int(p) for p in positions) + rows
    per_key = 4 * int(model["n_heads"]) * int(model["d_head"])
    flops = 2 * rows * c.token_params + c.attn_layers * per_key * keys
    unread = (int(model["vocab_size"]) - rows) * c.table_row_bytes
    logits = (rows * int(model["vocab_size"])
              * DTYPES[model["dtype"]].itemsize)
    return StepWork(flops, c.weight_bytes - max(unread, 0)
                    + c.kv_bytes * keys + logits)


def bound_s(model: Dict, w: StepWork) -> float:
    """The larger of the step's operations at the served dtype's dense
    peak and its bytes at HBM's."""
    return max(w.flops / PEAK_FLOPS[DTYPES[model["dtype"]]],
               w.nbytes / PEAK_BYTES)


def flops_s(model: Dict, w: StepWork) -> float:
    """The step's operations alone at the served dtype's dense peak."""
    return w.flops / PEAK_FLOPS[DTYPES[model["dtype"]]]
