"""The inputs of a language-model cell, drawn from the seed on the card:
the weights, in the tree the port's model takes, and the sessions'
tokens. Both sides are handed the same tensors; neither makes them.

The tree's leaves, their shapes and dtypes are the model's
(``zoo.build(cfg).abstract_params()``, which allocates nothing); their
values are drawn here, a leaf a call, every layer of a stacked leaf at
once, in the dtype the leaf is served in:

* a vector (a norm's scale): 1 plus a tenth of a standard normal;
* the token table: standard normal times 0.02;
* any other matrix: standard normal at its fan-in scale,
  ``1 / sqrt(fan-in)``. The fan-in is the matrix's first axis (the port
  multiplies ``x @ w``), or its second where the first counts the
  experts.

A leaf under ``blocks`` carries the layers of its slot on a leading axis,
which is not part of its matrix. Tokens are uniform over the real
vocabulary."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.operands import DTYPES


def matrix_shape(path: Tuple, leaf: torch.Tensor) -> Tuple[int, ...]:
    """A leaf's shape without its stacked axis of layers."""
    return tuple(leaf.shape[1:] if "blocks" in path else leaf.shape)


def is_expert(model: Dict, shape: Tuple[int, ...]) -> bool:
    """A matrix per expert: three axes, the first the experts."""
    e = int(model.get("n_experts", 0))
    return e > 0 and len(shape) == 3 and shape[0] == e


def _draw(model: Dict, path: Tuple, leaf: torch.Tensor,
          gen: torch.Generator) -> torch.Tensor:
    shape = matrix_shape(path, leaf)
    x = torch.randn(tuple(leaf.shape), generator=gen, device=gen.device,
                    dtype=leaf.dtype)
    if len(shape) == 1:
        return x.mul_(0.1).add_(1.0)
    if path[-1] == "tok":
        return x.mul_(0.02)
    fan_in = shape[1] if is_expert(model, shape) else shape[0]
    return x.mul_(1 / math.sqrt(fan_in))


def draw_weights(model: Dict, gen: torch.Generator) -> Dict:
    """The model's weights for ``model`` (a configuration file's ``model``
    object) on ``gen``'s device, drawn from ``gen``."""
    from repro_torch.common.pytree import tree_map_with_path
    from repro_torch.models import zoo
    from repro_torch.models.config import ModelConfig

    tree = zoo.build(ModelConfig(**model)).abstract_params()
    return tree_map_with_path(
        lambda path, leaf: _draw(model, path, leaf, gen), tree)


def draw_tokens(model: Dict, rows: int, prompt_len: int, forced: int,
                gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each session's prompt (rows, prompt_len) and the tokens it is fed
    while it decodes (rows, forced), int32, uniform over the vocabulary."""
    v = int(model["vocab_size"])
    prompts = torch.randint(0, v, (rows, prompt_len), generator=gen,
                            device=gen.device, dtype=torch.int32)
    fed = torch.randint(0, v, (rows, forced), generator=gen,
                        device=gen.device, dtype=torch.int32)
    return prompts, fed
