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

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.zoo import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    cache_dtype: str = "bfloat16"
    context_parallel: bool = False    # shard cache sequence over 'data'
    max_steps: int = 32


def make_decode_step(model: Model, axes=None):
    """serve_step(params, cache, tokens (B,1), pos (B,)) -> (logits,
    cache)."""
    cfg = model.cfg

    def serve_step(params, cache, tokens, pos):
        return T.decode_step(params, cache, tokens, pos, cfg, axes)

    return serve_step


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
