"""Traffic of kind ``decode``: a fixed batch of sessions decoding together
through the port's serving path, closed loop.

Set-up draws the weights and every session's tokens from the seed
(``portbench.lm_inputs``), and prefills each session's prompt through
``serve.engine.make_prefill(model, with_cache=True)``, one session a
call, into its slot of one cache of ``s_max`` positions. Session b then
decodes from its position ``positions[b]``, frozen in the mix: its
prompt runs to ``positions[b]`` rounded up to ``PREFILL_MULTIPLE`` (at
most ``s_max``), and
the cache past ``positions[b]`` is stale and masked, so the session
attends to its prompt's first ``positions[b]`` tokens and the tokens fed
since.

A unit is one step of every session: ``engine.make_decode_step`` with
session b's next fed token at ``positions[b] + j``, ``j`` the step's place
in a cycle of ``cycle`` steps, keeping the cache it returns. After a
cycle the positions start again and every cycle repeats the same values,
so every seed gives the same work. A unit returns ``[logits, positions,
written]``: the real vocabulary's logits (bfloat16), the positions fed,
and the keys and values the step wrote there, read back from the cache
it returned, (2, layers, sessions, kv heads, d_head) for K and V."""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.common.pytree import tree_leaves, tree_leaves_with_path
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig
from repro_torch.serve import engine

from portbench import lm_inputs, lm_work, mix

#: A prompt's length is a multiple of this: the port's prefill attention
#: takes the largest power of two dividing the length as its chunk
#: (``layers._pick_chunk``), so an odd length runs a position a chunk.
PREFILL_MULTIPLE = 256


class Traffic(mix.Traffic):
    unit = "step"

    def __init__(self, mix_: Dict, config: Dict, accel, device):
        self.mix, self.config, self.accel = mix_, config, accel
        self.device = torch.device(device)
        self.model = zoo.build(ModelConfig(**config["model"]))
        self.start = [int(p) for p in mix_["positions"]]
        self.tasks = [f"session{b}" for b in range(len(self.start))]
        self.n_sets = 1     # one cache, the program's state
        self.cycle = int(mix_["cycle"])
        self.s_max = int(mix_["s_max"])
        if not (min(self.start) >= 1
                and max(self.start) + self.cycle <= self.s_max):
            raise ValueError("every position must be at least 1 and leave "
                             "a cycle's steps inside s_max")
        self.prompt = [min(-(-p // PREFILL_MULTIPLE) * PREFILL_MULTIPLE,
                           self.s_max) for p in self.start]
        model, dtype = config["model"], config["cache_dtype"]
        c = lm_work.counts(model, dtype)
        works = [lm_work.step_work(model, [p + j for p in self.start],
                                   dtype, c) for j in range(self.cycle)]
        self.bound = sum(lm_work.bound_s(model, w) for w in works) / len(
            works)
        self.flops = sum(lm_work.flops_s(model, w) for w in works) / len(
            works)
        self.step = 0

    def prepare(self, gen: torch.Generator) -> None:
        model, dev = self.config["model"], self.device
        self.weights = lm_inputs.draw_weights(model, gen)
        self.prompts, self.fed = lm_inputs.draw_tokens(
            model, len(self.start), max(self.prompt), self.cycle, gen)
        start = torch.tensor(self.start, dtype=torch.int32, device=dev)
        self.positions = [start + j for j in range(self.cycle)]
        self.rows = torch.arange(len(self.start), device=dev)
        self.decode = engine.make_decode_step(self.model)
        with torch.inference_mode():
            self.cache = self._prefill()

    def _prefill(self) -> Dict:
        dtype = lm_inputs.DTYPES[self.config["cache_dtype"]]
        cache = self.model.init_cache(len(self.start), self.s_max,
                                      dtype=dtype, device=self.device)
        prefill = engine.make_prefill(self.model, with_cache=True)
        for b, p in enumerate(self.prompt):
            part = self.model.init_cache(1, p, dtype=dtype,
                                         device=self.device)
            _, part = prefill(self.weights, part, self.prompts[b:b + 1, :p])
            # A slot's stacked leaves keep the layers on axis 0, the rows
            # on axis 1; a one-session leaf goes into row b, its first p
            # positions where it has positions.
            for (path, t), one in zip(tree_leaves_with_path(cache),
                                      tree_leaves(part)):
                lead = (slice(None),) if path[0] == "blocks" else ()
                one = one[lead + (0,)]
                t[lead + (b,)][tuple(slice(0, n) for n in one.shape)
                               ].copy_(one)
            del part
        return cache

    def _written(self, pos: torch.Tensor) -> torch.Tensor:
        """The keys and values at each session's ``pos`` in the cache,
        layers in the tree's order."""
        got = {"k": [], "v": []}
        for path, t in tree_leaves_with_path(self.cache):
            if path[-1] in got:
                got[path[-1]].append(
                    t[:, self.rows, pos] if path[0] == "blocks"
                    else t[self.rows, pos][None])
        return torch.stack([torch.cat(got["k"]), torch.cat(got["v"])])

    def run(self, s) -> List[torch.Tensor]:
        j = self.step % self.cycle
        self.step += 1
        pos = self.positions[j]
        with torch.inference_mode():
            logits, self.cache = self.decode(
                self.weights, self.cache, self.fed[:, j:j + 1], pos)
            written = self._written(pos)
        return [logits[:, 0, :int(self.config["model"]["vocab_size"])], pos,
                written]

    def operands(self, s) -> List[Dict]:
        """What the reference needs to judge a unit: the weights and
        tokens both sides were handed, and each session's start."""
        return [{"weights": self.weights, "prompts": self.prompts,
                 "fed": self.fed, "start": self.start,
                 "model": self.config["model"]}]

    def bound_s(self, s) -> float:
        """A step's bound averaged over the cycle (its keys differ from
        step to step by the cycle's offset)."""
        return self.bound

    def flops_s(self, s) -> float:
        """A step's operations at the dense peak, averaged alike."""
        return self.flops

    def release(self) -> None:
        """Drop the cache, the program's state, before the check."""
        self.cache = None
