"""LM serving: prefill + batched greedy decode with KV caches — the port of
``repro.serve.engine``.

JAX jits the prefill and the decode step; here each is an eager call under
``torch.inference_mode()``. ``greedy_generate`` and
``greedy_generate_reference`` are entry points: they run on the card
unless the caller passes ``device="cpu"``, and the params must already lie
there. The context-parallel cache waits for the sharding slice
(``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import mla_decode
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import mla as A
from repro_torch.models import transformer as T
from repro_torch.models.zoo import Model
from repro_torch.obs import trace


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    cache_dtype: str = "bfloat16"
    context_parallel: bool = False    # shard cache sequence over 'data'
    max_steps: int = 32


def make_decode_step(model: Model, axes=None, graph: bool = False):
    """serve_step(params, cache, tokens (B,1), pos (B,)) -> (logits,
    cache).

    ``graph`` (latent-attention models, no mesh): the step writes the
    cache it is given and returns it, and on the card runs as one captured
    CUDA graph (:class:`GraphedDecode`): a step costs the host one replay
    in place of a launch an op."""
    cfg = model.cfg
    if graph:
        return GraphedDecode(cfg, axes)

    def serve_step(params, cache, tokens, pos):
        return T.decode_step(params, cache, tokens, pos, cfg, axes)

    return serve_step


class GraphedDecode:
    """A latent-attention model's decode step, its cache written in place
    (``transformer.decode_step(..., in_place=True)``), captured once as a
    CUDA graph and replayed.

    Each call bounds ``pos`` on the host (``transformer.check_positions``).
    The first call with given params, cache leaves and input shapes runs
    the step once eagerly on a side stream, where the lazy initialisations
    that a capture must not meet happen (a step writes only the positions
    it then reads back, so the replay that follows leaves the same cache),
    then captures it. A call copies ``tokens`` and ``pos`` into the graph's
    inputs and replays it (span ``repro.decode.replay``); it returns a copy
    of the graph's logits and the cache it was given, written. On the CPU,
    which has no graphs, the same in-place step runs eagerly. Each call
    gives the counter ``repro.mla.attend_launches``: the absorbed-attention
    kernel's launches in the captured step (:attr:`attend_launches`,
    counted at capture), 0 on the CPU. The object holds the params and the
    cache it captured until it is dropped."""

    def __init__(self, cfg, axes=None):
        if axes is not None:
            raise NotImplementedError(
                "a captured decode step runs without a mesh")
        self.cfg = cfg
        self.graph = None
        self._for = None      # (params, cache leaves, input shapes)
        self.attend_launches = 0

    def _captured(self, key) -> bool:
        held = self._for
        return (held is not None and held[0] is key[0]
                and held[2] == key[2] and len(held[1]) == len(key[1])
                and all(a is b for a, b in zip(held[1], key[1])))

    def _capture(self, key, cache, tokens, pos) -> None:
        self.graph = self.logits = self._for = None   # free an older pool
        params, dev = key[0], tokens.device
        self.tokens, self.pos = tokens.clone(), pos.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            T.decode_step(params, cache, self.tokens, self.pos, self.cfg,
                          in_place=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = mla_decode.launches["mla_attend"]
        with torch.cuda.graph(graph):
            self.logits, _ = T.decode_step(params, cache, self.tokens,
                                           self.pos, self.cfg, in_place=True)
        self.attend_launches = mla_decode.launches["mla_attend"] - before
        self.graph, self._for = graph, key

    def __call__(self, params, cache, tokens, pos):
        T.check_positions(cache, pos, self.cfg)
        with torch.inference_mode():
            if tokens.device.type != "cuda":
                A.count_launches(0)
                return T.decode_step(params, cache, tokens, pos, self.cfg,
                                     in_place=True)
            key = (params, tree_leaves(cache),
                   (tuple(tokens.shape), tuple(pos.shape)))
            if not self._captured(key):
                self._capture(key, cache, tokens, pos)
            self.tokens.copy_(tokens)
            self.pos.copy_(pos)
            A.count_launches(self.attend_launches)
            with trace.TRACE.span("repro.decode.replay"):
                self.graph.replay()
            return self.logits.clone(), cache


def make_prefill(model: Model, axes=None, with_cache: bool = False):
    """Make the full-sequence prefill.

    ``with_cache=False``: ``prefill(params, batch) -> (last-position
    logits, aux)``. ``with_cache=True`` (the serving path):
    ``prefill(params, cache, tokens) -> (last-position logits, cache
    filled through the prompt)`` — one parallel pass over the whole
    prompt, after which generation continues with
    :func:`make_decode_step`."""
    cfg = model.cfg

    if with_cache:
        def prefill_cache(params, cache, tokens):
            return T.prefill_with_cache(params, cache, tokens, cfg, axes)

        return prefill_cache

    def prefill(params, batch):
        logits, aux = T.forward(params, batch, cfg, axes)
        return logits[:, -1:, :], aux

    return prefill


def prefill_encdec_cache(model: Model, params, frames: torch.Tensor,
                         cache: dict, axes=None) -> dict:
    """Run the encoder and fill every decoder layer's cross K/V cache:
    a new cache; the one given is not written."""
    cfg = model.cfg
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} is {cfg.family}, not enc-dec")
    enc_out = T.encode(params, frames, cfg, axes)

    def fill(block_p, block_c, stacked: bool):
        wk, wv = block_p["cross"]["wk"], block_p["cross"]["wv"]
        eq = "bsd,pdhe->pbshe" if stacked else "bsd,dhe->bshe"
        ck = torch.einsum(eq, enc_out, wk).to(block_c["ck"].dtype)
        cv = torch.einsum(eq, enc_out, wv).to(block_c["cv"].dtype)
        return dict(block_c, ck=ck, cv=cv)

    return {"blocks": {slot: fill(params["blocks"][slot], bc, True)
                       for slot, bc in cache["blocks"].items()},
            "tail": [fill(tp, tc, False)
                     for tp, tc in zip(params["tail"], cache["tail"])]}


def _on(params, prompt: torch.Tensor, device) -> torch.Tensor:
    """The prompt on the resolved device, which must be the params'."""
    dev = resolve_device(device)
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"params lie on {where}, generation asked for on "
                         f"{dev}")
    return prompt.to(where)


def _next_token(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Greedy choice over the real vocabulary (the padded tail excluded)."""
    return torch.argmax(logits[:, -1, :vocab_size],
                        dim=-1)[:, None].to(torch.int32)


def greedy_generate(model: Model, params, prompt: torch.Tensor,
                    n_steps: int, s_max: int, axes=None,
                    enc_batch: Optional[Dict] = None,
                    device=None) -> torch.Tensor:
    """Batched greedy decoding: one full-sequence prefill, then a loop of
    single-token decode steps. prompt (B, S) -> (B, S + n_steps).

    Enc-dec models take JAX's path: the token-by-token
    :func:`greedy_generate_reference`, whose cross caches are empty
    (``enc_len=0``), so the decoder attends to no encoder output;
    ``enc_batch`` is accepted and unused, as in JAX."""
    cfg = model.cfg
    prompt = _on(params, prompt, device)
    b, s_prompt = prompt.shape
    if n_steps <= 0:
        return prompt
    if cfg.family == "encdec":
        return greedy_generate_reference(model, params, prompt, n_steps,
                                         s_max, axes, device=device)
    prefill = make_prefill(model, axes, with_cache=True)
    step = make_decode_step(model, axes)
    with torch.inference_mode():
        cache = model.init_cache(b, s_max, device=prompt.device)
        logits, cache = prefill(params, cache, prompt)
        tokens = _next_token(logits, cfg.vocab_size)
        out = [prompt.to(torch.int32), tokens]
        for i in range(n_steps - 1):
            pos = torch.full((b,), s_prompt + i, dtype=torch.int32,
                             device=prompt.device)
            logits, cache = step(params, cache, tokens, pos)
            tokens = _next_token(logits, cfg.vocab_size)
            out.append(tokens)
        return torch.cat(out, dim=1)


def greedy_generate_reference(model: Model, params, prompt: torch.Tensor,
                              n_steps: int, s_max: int, axes=None,
                              device=None) -> torch.Tensor:
    """The token-by-token loop (the prompt fed through ``decode_step``),
    kept as the equivalence oracle for :func:`greedy_generate`'s
    single-pass prefill."""
    cfg = model.cfg
    prompt = _on(params, prompt, device)
    b, s_prompt = prompt.shape
    step = make_decode_step(model, axes)
    with torch.inference_mode():
        cache = model.init_cache(b, s_max, device=prompt.device)
        tokens = prompt[:, :1].to(torch.int32)
        out = [tokens]
        for i in range(s_prompt + n_steps - 1):
            pos = torch.full((b,), i, dtype=torch.int32,
                             device=prompt.device)
            logits, cache = step(params, cache, tokens, pos)
            if i + 1 < s_prompt:
                tokens = prompt[:, i + 1:i + 2].to(torch.int32)
            else:
                tokens = _next_token(logits, cfg.vocab_size)
            out.append(tokens)
        return torch.cat(out, dim=1)
