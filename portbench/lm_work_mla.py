"""The work of one decode step of a model with latent attention (MLA,
DeepSeek-V2) and the least time the card could take for it, counted from
the model's own weight and cache trees, as ``portbench.lm_work`` counts a
model with a key and value cache.

A step feeds one token to each row at its own position. Its operations
are twice the weights each token multiplies through (every matrix but
the token table, which is looked up; of the routed experts'
``experts_per_token`` of ``n_experts``; the shared experts, the dense
layers and the head whole) plus the absorbed attention, ``n_heads * (2 *
(kv_lora_rank + qk_rope) + 2 * kv_lora_rank)`` operations a key and
layer (a head's scores against the latent and the rope key, and its
weighted sum of the latents), over each row's keys and its own. Its
bytes are the weights it reads, once each: every weight outside the
routed experts (of an untied token table only the rows looked up), and
of the routed experts' the share a step is expected to pick, ``1 - (1 -
k / E) ** rows`` of them; each cached latent and rope key read once, one
of each written a row and layer; and the logits written once. Peaks as in
``portbench.work``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from portbench import lm_inputs
from portbench.lm_work import StepWork
from portbench.operands import DTYPES
from portbench.work import PEAK_BYTES, PEAK_FLOPS


@dataclass(frozen=True)
class Counts:
    """What a step's work is made of, for one model."""

    weight_bytes: int       # every weight but the routed experts'
    expert_bytes: int       # the routed experts' weights
    table_row_bytes: int    # a row of an untied token table (else 0)
    token_params: int       # the weights one token multiplies through
    mla_layers: int         # layers that attend over a latent cache
    latent_bytes: int       # one position's latent and rope key, every layer


def counts(model: Dict, cache_dtype: str) -> Counts:
    from repro_torch.common.pytree import tree_leaves_with_path
    from repro_torch.models import zoo
    from repro_torch.models.config import ModelConfig

    built = zoo.build(ModelConfig(**model))
    v, vp = int(model["vocab_size"]), built.padded_vocab
    share = int(model["experts_per_token"]) / int(model["n_experts"])
    weight_bytes = expert_bytes = table_row_bytes = token_params = 0
    for path, leaf in tree_leaves_with_path(built.abstract_params()):
        n = leaf.numel()
        if path[0] == "embed":          # (V padded, D) or (D, V padded)
            n = n // vp * v
        shape = lm_inputs.matrix_shape(path, leaf)
        expert = lm_inputs.is_expert(model, shape)
        if expert:
            expert_bytes += n * leaf.element_size()
        else:
            weight_bytes += n * leaf.element_size()
        if path[-1] == "tok":
            if model["tie_embeddings"]:
                token_params += n       # the head
            else:
                table_row_bytes = leaf.shape[-1] * leaf.element_size()
        elif len(shape) > 1:
            token_params += n * share if expert else n
    cache = built.init_cache(1, 1, dtype=DTYPES[cache_dtype], device="meta")
    lat = [leaf for path, leaf in tree_leaves_with_path(cache)
           if path[-1] in ("c", "k_pe")]
    # A (layers, 1 row, 1 position, width) leaf each of c and k_pe where
    # stacked, (1, 1, width) where not.
    mla_layers = sum(leaf.numel() // leaf.shape[-1] for leaf in lat
                     if leaf.shape[-1] == int(model["kv_lora_rank"]))
    latent_bytes = sum(leaf.numel() * leaf.element_size() for leaf in lat)
    return Counts(weight_bytes, expert_bytes, table_row_bytes,
                  int(token_params), mla_layers, latent_bytes)


def expert_share(model: Dict, rows: int) -> float:
    """The expected share of a layer's routed experts that ``rows`` tokens
    pick, each taking ``experts_per_token`` of ``n_experts``."""
    k, e = int(model["experts_per_token"]), int(model["n_experts"])
    return 1.0 - (1.0 - k / e) ** rows


def flops_per_key(model: Dict) -> int:
    """The absorbed attention's operations a key and layer."""
    r, rope = int(model["kv_lora_rank"]), int(model["qk_rope_head_dim"])
    return int(model["n_heads"]) * (2 * (r + rope) + 2 * r)


def step_work(model: Dict, positions: Sequence[int],
              cache_dtype: str = "bfloat16",
              c: Optional[Counts] = None) -> StepWork:
    """One step of ``len(positions)`` rows, row b feeding its token at
    position ``positions[b]`` (so ``positions[b]`` keys before it);
    ``c``, the model's counts where already taken."""
    c = c or counts(model, cache_dtype)
    rows = len(positions)
    keys = sum(int(p) for p in positions) + rows
    flops = 2 * rows * c.token_params + c.mla_layers * flops_per_key(
        model) * keys
    unread = (int(model["vocab_size"]) - rows) * c.table_row_bytes
    logits = (rows * int(model["vocab_size"])
              * DTYPES[model["dtype"]].itemsize)
    nbytes = (c.weight_bytes - max(unread, 0)
              + round(c.expert_bytes * expert_share(model, rows))
              + c.latent_bytes * keys + logits)
    return StepWork(flops, nbytes)


def bound_s(model: Dict, w: StepWork) -> float:
    """The larger of the step's operations at the served dtype's dense
    peak and its bytes at HBM's."""
    return max(w.flops / PEAK_FLOPS[DTYPES[model["dtype"]]],
               w.nbytes / PEAK_BYTES)


def flops_s(model: Dict, w: StepWork) -> float:
    """The step's operations alone at the served dtype's dense peak."""
    return w.flops / PEAK_FLOPS[DTYPES[model["dtype"]]]
