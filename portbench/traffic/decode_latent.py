"""Traffic of kind ``decode_latent``: the ``decode`` traffic
(``traffic/decode.py``) for a model whose attention caches a latent
(MLA, DeepSeek-V2): a fixed batch of sessions decoding together through
the port's serving path, closed loop, a unit one step of every session.

Only the step and what reads the cache differ. The step is the port's
latent one, ``serve.engine.make_decode_step(model, graph=True)``: the
cache written in place, on the card captured once as a CUDA graph (in the
warm-up) and replayed. A unit returns ``[logits, positions, written]``,
``written`` the latent ``c`` and rope key ``k_pe`` each layer wrote at
each session's position, read back from the cache the step returned,
(layers, sessions, kv_lora_rank + qk_rope), layers in the model's order
(the leading dense ones first). The work count is
``portbench.lm_work_mla``'s."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.serve import engine

from portbench import lm_work_mla
from portbench.spec import HERE, load_module

decode = load_module(HERE / "traffic" / "decode.py",
                     "portbench_traffic_decode")


class Traffic(decode.Traffic):
    def __init__(self, mix_: Dict, config: Dict, accel, device):
        super().__init__(mix_, config, accel, device)
        model, dtype = config["model"], config["cache_dtype"]
        c = lm_work_mla.counts(model, dtype)
        works = [lm_work_mla.step_work(model, [p + j for p in self.start],
                                       dtype, c) for j in range(self.cycle)]
        self.bound = sum(lm_work_mla.bound_s(model, w)
                         for w in works) / len(works)
        self.flops = sum(lm_work_mla.flops_s(model, w)
                         for w in works) / len(works)

    def prepare(self, gen: torch.Generator) -> None:
        super().prepare(gen)
        self.decode = engine.make_decode_step(self.model, graph=True)

    def release(self) -> None:
        """Drop the cache and the captured step, which holds it."""
        super().release()
        self.decode = None

    def _written(self, pos: torch.Tensor) -> torch.Tensor:
        """The latents and rope keys at each session's ``pos`` in the
        cache, one row a layer in the model's order."""
        got = []
        for group, stacked in (("lead", False), ("blocks", True),
                               ("tail", False)):
            caches = self.cache.get(group, ())
            for c in (caches.values() if stacked else caches):
                if "c" not in c:
                    continue
                at = ((slice(None), self.rows, pos) if stacked
                      else (self.rows, pos))
                lat = torch.cat([c["c"][at], c["k_pe"][at]], dim=-1)
                got.append(lat if stacked else lat[None])
        return torch.cat(got)
