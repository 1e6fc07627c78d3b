"""Unified decoder — the port of ``repro.models.transformer`` for the
attention families: ``dense``, ``moe`` and ``vlm`` (the vision stub:
precomputed patch embeddings through a learned adapter, prepended to the
text).

Layer kinds ``global`` (full attention) and ``local`` (sliding window).
Params keep JAX's nesting: ``{"embed", "final_norm", "blocks": {"s0":
...}, "tail": [...]}``, each ``blocks`` slot stacked along a leading
period axis as JAX's ``_stack`` does. JAX scans the stacked periods; here
a Python loop walks the leading axis, then the tail. The SSD and RG-LRU
kinds (mamba2, recurrentgemma) and the enc-dec family (whisper) raise
:class:`NotImplementedError`: they are the next slice of the port
(``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig

ATTENTION_KINDS = ("global", "local")
FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    kinds = set(cfg.layer_kinds()) - set(ATTENTION_KINDS)
    if cfg.family not in FAMILIES or kinds:
        what = sorted(kinds) or [cfg.family]
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet; repro_torch runs the "
            f"attention families {FAMILIES} (global/local blocks). The SSD "
            "and RG-LRU blocks and the enc-dec path are the next slice of "
            "ROADMAP.md queue 1")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 256) * 256


def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.family == "moe" and kind in ATTENTION_KINDS


# ------------------------------------------------------------- block init
def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                dtype) -> dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(d, dtype, gen.device),
                         "norm2": L.rmsnorm_init(d, dtype, gen.device),
                         "attn": L.init_attention(gen, cfg, dtype)}
    if _is_moe(cfg, kind):
        p["ffn"] = M.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = L.init_mlp(gen, cfg, dtype)
    return p


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of dicts and lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _index(tree, i: int):
    return _tree_map(lambda t: t[i], tree)


def _stacked_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                   dtype, n: int) -> dict:
    """``n`` blocks stacked along a leading axis, each written into the
    stack as it is drawn (one block's temporaries at a time)."""
    first = _init_block(gen, kind, cfg, dtype)
    stack = _tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    for r in range(n):
        block = first if r == 0 else _init_block(gen, kind, cfg, dtype)
        _tree_map(lambda dst, src: dst[r].copy_(src), stack, block)
        del block
    return stack


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    cfg.validate()
    check_supported(cfg)
    dtype = cfg.param_dtype
    n_periods, period, tail = cfg.pattern_split()
    params: Dict[str, Any] = {
        "embed": {"tok": (torch.randn((padded_vocab(cfg), cfg.d_model),
                                      generator=gen, device=gen.device)
                          * 0.02).to(dtype)},
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["embed"]["head"] = L.dense_init(gen, cfg.d_model,
                                               padded_vocab(cfg), dtype)
    params["blocks"] = {f"s{si}": _stacked_block(gen, kind, cfg, dtype,
                                                 n_periods)
                        for si, kind in enumerate(period)}
    params["tail"] = [_init_block(gen, kind, cfg, dtype) for kind in tail]
    if cfg.frontend == "vision_stub":
        params["frontend"] = {
            "adapter": L.dense_init(gen, cfg.d_model, cfg.d_model, dtype)}
    return params


def _layers(cfg: ModelConfig, params: dict, cache: Optional[dict] = None):
    """(kind, block params, block cache, slot) in layer order: the stacked
    periods along their leading axis, then the tail. ``slot`` is
    ``(si, period index)`` for a stacked block, ``(None, tail index)`` for
    the tail."""
    n_periods, period, tail = cfg.pattern_split()
    for i in range(n_periods):
        for si, kind in enumerate(period):
            key = f"s{si}"
            c = None if cache is None else _index(cache["blocks"][key], i)
            yield kind, _index(params["blocks"][key], i), c, (key, i)
    for ti, kind in enumerate(tail):
        c = None if cache is None else cache["tail"][ti]
        yield kind, params["tail"][ti], c, (None, ti)


def _gather_cache(cfg: ModelConfig, new: dict) -> dict:
    """Restack the per-layer caches ``{slot: cache}`` as the cache tree."""
    n_periods, period, tail = cfg.pattern_split()
    blocks = {}
    for si in range(len(period)):
        key = f"s{si}"
        per = [new[(key, i)] for i in range(n_periods)]
        blocks[key] = _tree_map(lambda *xs: torch.stack(xs), *per)
    return {"blocks": blocks,
            "tail": [new[(None, ti)] for ti in range(len(tail))]}


# ------------------------------------------------------------ block apply
def _ffn(p: dict, kind: str, h2: torch.Tensor, cfg: ModelConfig):
    """The block's FFN: (out, (weights, experts)) for an MoE block, (out,
    None) for an MLP."""
    if _is_moe(cfg, kind):
        return M.moe_mlp(p["ffn"], h2, cfg)
    return L.mlp(p["ffn"], h2, cfg), None


def _apply_block(kind: str, p: dict, x, cfg, positions, aux):
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == "local" else None
    x = x + L.attention(p["attn"], h, cfg, positions=positions,
                        causal=True, window=window)
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, routing = _ffn(p, kind, h2, cfg)
    if routing is not None:
        aux = aux + M.aux_load_balance_loss(*routing, cfg.n_experts)
    return x + y, aux


# ------------------------------------------------------------ full forward
def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            axes=None, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward -> (logits (B, S, Vp), aux_loss scalar).

    ``return_hidden=True`` returns final hidden states instead of logits.
    batch: tokens (B, S_text); optional 'frontend' (B, n_front, D) patch
    embeddings (VLM). The MoE aux loss sums over the MoE blocks (float32
    zero for the other families).
    """
    L.check_axes(axes)
    check_supported(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg)
    if cfg.frontend == "vision_stub":
        fr = torch.einsum("bsd,de->bse", batch["frontend"].to(x.dtype),
                          params["frontend"]["adapter"])
        x = torch.cat([fr, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p, _, _ in _layers(cfg, params):
        x, aux = _apply_block(kind, p, x, cfg, positions, aux)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux
    return L.logits(params["embed"], x, cfg), aux


# ---------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
               enc_len: int = 0, device=None) -> dict:
    """Decode cache tree mirroring the block structure, zeros on
    ``device`` (the caller resolves it)."""
    check_supported(cfg)
    dtype = dtype or cfg.param_dtype
    n_periods, period, tail = cfg.pattern_split()

    def one(lead=()):
        shape = (*lead, batch, s_max, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"blocks": {f"s{si}": one((n_periods,))
                       for si in range(len(period))},
            "tail": [one() for _ in tail]}


def _decode_block(kind: str, p: dict, c: dict, x, pos, cfg):
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == "local" else None
    y, k2, v2 = L.decode_attention(p["attn"], h, c["k"], c["v"], pos, cfg,
                                   window=window)
    x = x + y
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, _ = _ffn(p, kind, h2, cfg)
    return x + y, dict(c, k=k2, v=v2)


def _prefill_block(kind: str, p: dict, c: dict, x, positions, cfg):
    """Full-sequence twin of :func:`_decode_block`: the block output for
    the whole prompt in parallel, plus the decode cache after it (K/V
    written at positions ``[0, S)``, as the per-token decode writes them:
    same projections and bias, RoPE at each position)."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == "local" else None
    x = x + L.attention(p["attn"], h, cfg, positions=positions,
                        causal=True, window=window)
    _, k, v = L.qkv_project(p["attn"], h, cfg)
    cos, sin = L.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    k = L.apply_rope(k, cos, sin)
    s = k.shape[1]
    k2, v2 = c["k"].clone(), c["v"].clone()
    k2[:, :s] = k.to(k2.dtype)
    v2[:, :s] = v.to(v2.dtype)
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, _ = _ffn(p, kind, h2, cfg)
    return x + y, dict(c, k=k2, v=v2)


def prefill_with_cache(params, cache: dict, tokens: torch.Tensor,
                       cfg: ModelConfig, axes=None
                       ) -> Tuple[torch.Tensor, dict]:
    """Single full-sequence prefill that also fills the decode cache.

    tokens (B, S) -> (last-position logits (B, 1, Vp), a new cache filled
    through position S): one parallel forward instead of S sequential
    ``decode_step`` calls, after which generation continues with
    ``decode_step`` at position S. The cache given is not written.
    """
    L.check_axes(axes)
    check_supported(cfg)
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    new = {}
    for kind, p, c, slot in _layers(cfg, params, cache):
        x, new[slot] = _prefill_block(kind, p, c, x, positions, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(params["embed"], x[:, -1:, :], cfg)
    return lg, _gather_cache(cfg, new)


def decode_step(params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, axes=None) -> Tuple[torch.Tensor, dict]:
    """One decoding step: tokens (B, 1), pos (B,) -> (logits (B, 1, Vp),
    a new cache). Every ``pos`` must lie inside the cache (one host read of
    ``pos``); JAX's dynamic-update-slice would clamp it silently."""
    L.check_axes(axes)
    check_supported(cfg)
    s_max = _cache_len(cache)
    if bool(((pos < 0) | (pos >= s_max)).any()):
        raise ValueError(f"decode position {pos.tolist()} outside the "
                         f"cache of {s_max} positions")
    x = L.embed(params["embed"], tokens, cfg)
    new = {}
    for kind, p, c, slot in _layers(cfg, params, cache):
        x, new[slot] = _decode_block(kind, p, c, x, pos, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.logits(params["embed"], x, cfg), _gather_cache(cfg, new)


def _cache_len(cache: dict) -> int:
    """S_max of a cache tree (the sequence axis of any K cache)."""
    if cache["tail"]:
        return cache["tail"][0]["k"].shape[1]
    return next(iter(cache["blocks"].values()))["k"].shape[2]
