"""Unified model — the port of ``repro.models.transformer``: one
implementation for the dense, MoE, SSM, hybrid, enc-dec and VLM families
through *layer kinds*.

Layer kinds: ``global`` (full attention), ``local`` (sliding window),
``mla`` (latent attention, :mod:`repro_torch.models.mla`; the port's
own), ``recurrent`` (RG-LRU), ``ssd`` (Mamba2) and ``enc``
(bidirectional, the encoder's). Params keep JAX's nesting: ``{"embed",
"final_norm", "blocks": {"s0": ...}, "tail": [...]}`` and, for enc-dec,
an ``encoder`` subtree of the same form; each ``blocks`` slot is stacked
along a leading period axis as JAX's ``_stack`` does. A model with
leading dense layers (``first_dense_layers``, DeepSeek-V2's) also has
``"lead": [...]``, their blocks, whose FFN is a dense SwiGLU of width
``d_ff_dense``; they run before the stacked periods. JAX scans the
stacked periods; here a Python loop walks the lead, the leading axis,
then the tail. The VLM and audio
frontends are stubs, as in JAX: precomputed patch or frame embeddings
through a learned adapter.

``axes`` (an :class:`~repro_torch.models.layers.Axes`) runs a model
sharded: params, inputs and caches are DTensors on one mesh (a plain
leaf counts as replicated), and the layers place activations as JAX's
sharding constraints do, every block kind on any mesh: the MoE experts
over the model axis, the SSD heads and the RG-LRU width over it where
they divide it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.common.pytree import tree_map
from repro_torch.models import layers as L
from repro_torch.models import mla as A
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S
from repro_torch.models.config import ModelConfig

ATTENTION_KINDS = ("global", "local", "mla")
KINDS = ATTENTION_KINDS + ("recurrent", "ssd", "enc")
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def check_supported(cfg: ModelConfig, axes=None) -> None:
    """Raise for a family or layer kind the model does not know, and for
    sharding axes with DeepSeek-V2's blocks (latent attention, shared
    experts, leading dense layers), which have no mesh path."""
    kinds = set(cfg.layer_kinds()) - set(KINDS)
    if cfg.family not in FAMILIES or kinds:
        what = sorted(kinds) or [cfg.family]
        raise NotImplementedError(
            f"{cfg.name}: unknown {what}; repro_torch runs the families "
            f"{FAMILIES} with the layer kinds {KINDS}")
    if axes is not None and (cfg.mla or cfg.n_shared_experts
                             or cfg.first_dense_layers):
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA), shared experts and "
            "leading dense layers run unsharded; no mesh path takes axes")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 256) * 256


def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.family == "moe" and kind in ATTENTION_KINDS


# ------------------------------------------------------------- block init
def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype,
                with_cross: bool = False, dense: bool = False) -> dict:
    """One block's params; ``dense``: a leading layer's dense FFN of width
    ``d_ff_dense``."""
    d, dev = cfg.d_model, gen.device
    if kind == "ssd":
        return {"norm1": L.rmsnorm_init(d, dtype, dev),
                "mix": S.init_mamba(gen, cfg, dtype)}
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(d, dtype, dev),
                         "norm2": L.rmsnorm_init(d, dtype, dev)}
    if kind == "recurrent":
        p["rec"] = R.init_rglru_block(gen, cfg, dtype)
    elif kind == "mla":
        p["attn"] = A.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype)
    if with_cross:
        p["norm_c"] = L.rmsnorm_init(d, dtype, dev)
        p["cross"] = L.init_attention(gen, cfg, dtype)
    if dense:
        p["ffn"] = L.init_mlp(gen, cfg, dtype, d_ff=cfg.d_ff_dense)
    elif _is_moe(cfg, kind):
        p["ffn"] = M.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = L.init_mlp(gen, cfg, dtype)
    return p


def _index(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _stacked_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                   dtype, n: int, with_cross: bool) -> dict:
    """``n`` blocks stacked along a leading axis, each written into the
    stack as it is drawn (one block's temporaries at a time)."""
    first = _init_block(gen, kind, cfg, dtype, with_cross)
    stack = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    for r in range(n):
        block = (first if r == 0
                 else _init_block(gen, kind, cfg, dtype, with_cross))
        tree_map(lambda dst, src: dst[r].copy_(src), stack, block)
        del block
    return stack


def _encoder_split(cfg: ModelConfig):
    """The encoder's (n_periods, period, tail): ``enc`` blocks only."""
    return cfg.n_enc_layers, ("enc",), ()


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    cfg.validate()
    check_supported(cfg)
    dtype, dev = cfg.param_dtype, gen.device
    params: Dict[str, Any] = {
        "embed": {"tok": (torch.randn((padded_vocab(cfg), cfg.d_model),
                                      generator=gen, device=dev)
                          * 0.02).to(dtype)},
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["embed"]["head"] = L.dense_init(gen, cfg.d_model,
                                               padded_vocab(cfg), dtype)

    def blocks(split, cross):
        n_periods, period, tail = split
        return ({f"s{si}": _stacked_block(gen, kind, cfg, dtype, n_periods,
                                          cross)
                 for si, kind in enumerate(period)},
                [_init_block(gen, kind, cfg, dtype, cross) for kind in tail])

    with_cross = cfg.family == "encdec"
    if cfg.first_dense_layers:
        params["lead"] = [_init_block(gen, kind, cfg, dtype, with_cross,
                                      dense=True)
                          for kind in cfg.lead_kinds()]
    params["blocks"], params["tail"] = blocks(cfg.pattern_split(),
                                              with_cross)
    if with_cross:
        enc_blocks, enc_tail = blocks(_encoder_split(cfg), False)
        params["encoder"] = {
            "blocks": enc_blocks,
            "tail": enc_tail,
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "adapter": L.dense_init(gen, cfg.d_model, cfg.d_model, dtype),
        }
    if cfg.frontend == "vision_stub":
        params["frontend"] = {
            "adapter": L.dense_init(gen, cfg.d_model, cfg.d_model, dtype)}
    return params


def _layers(cfg: ModelConfig, params: dict, cache: Optional[dict] = None):
    """(kind, block params, block cache, slot) in layer order: the leading
    dense blocks, the stacked periods along their leading axis, then the
    tail. ``slot`` is ``("lead", index)`` for a leading block, ``(si,
    period index)`` for a stacked block, ``(None, tail index)`` for the
    tail."""
    for li, kind in enumerate(cfg.lead_kinds()):
        c = None if cache is None else cache["lead"][li]
        yield kind, params["lead"][li], c, ("lead", li)
    n_periods, period, tail = cfg.pattern_split()
    # Each stacked param leaf split into its periods once (an unbind a
    # leaf), not indexed again for every layer: fewer host ops a step.
    slots = {k: _unstack(t, n_periods) for k, t in params["blocks"].items()}
    for i in range(n_periods):
        for si, kind in enumerate(period):
            key = f"s{si}"
            c = None if cache is None else _index(cache["blocks"][key], i)
            yield kind, slots[key][i], c, (key, i)
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
        blocks[key] = tree_map(lambda *xs: torch.stack(xs), *per)
    out = {"blocks": blocks,
           "tail": [new[(None, ti)] for ti in range(len(tail))]}
    if cfg.first_dense_layers:
        out["lead"] = [new[("lead", li)]
                       for li in range(cfg.first_dense_layers)]
    return out


# ------------------------------------------------------------ block apply
def _ffn(p: dict, h2: torch.Tensor, cfg: ModelConfig, axes):
    """The block's FFN: (out, (weights, experts)) for an MoE block (one
    with a router), (out, None) for an MLP."""
    if "router" in p["ffn"]:
        return M.moe_mlp(p["ffn"], h2, cfg, axes)
    return L.mlp(p["ffn"], h2, cfg, axes), None


def _apply_block(kind: str, p: dict, x, cfg, axes, positions, aux,
                 enc_kv=None):
    if kind == "ssd":
        return x + S.mamba_apply(
            p["mix"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
            axes), aux
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "recurrent":
        x = x + R.rglru_apply(p["rec"], h, cfg, axes)
    elif kind == "mla":
        x = x + A.mla_attention(p["attn"], h, cfg, positions)[0]
    else:
        window = cfg.sliding_window if kind == "local" else None
        x = x + L.attention(p["attn"], h, cfg, axes, positions=positions,
                            causal=(kind != "enc"), window=window)
    if "cross" in p and enc_kv is not None:
        hc = L.rmsnorm(x, p["norm_c"], cfg.norm_eps)
        x = x + L.attention(p["cross"], hc, cfg, axes, kv_override=enc_kv)
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, routing = _ffn(p, h2, cfg, axes)
    if routing is not None:
        aux = aux + M.aux_load_balance_loss(*routing, cfg.n_experts)
    return x + y, aux


# ------------------------------------------------------------ full forward
#: The outputs each remat policy keeps (JAX's ``save_only_these_names``).
SAVED_NAMES = {"block_save": ("attn_out", "moe_out"),
               "block_save_moe": ("moe_out",)}


def _save_named(names, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: save the outputs of the tag op
    (``layers.checkpoint_name``) named in ``names``, recompute the rest."""
    if op is L.TAG_OP and args[1] in names:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, cfg: ModelConfig):
    """JAX's ``_maybe_remat`` around one period of blocks: ``"block"``
    keeps only the period's inputs for backward and runs the period again
    there (``torch.utils.checkpoint``, non-reentrant); ``"block_save"``
    also keeps the named post-collective outputs ``attn_out`` and
    ``moe_out`` (``"block_save_moe"``: ``moe_out`` only), through
    selective checkpointing, so backward takes them from memory instead of
    recomputing them; ``"none"`` keeps every activation. Without autograd
    (serving) the period runs once either way."""
    if cfg.remat not in ("none", "block", *SAVED_NAMES):
        raise ValueError(f"remat={cfg.remat!r}: one of 'none', 'block', "
                         f"{', '.join(map(repr, SAVED_NAMES))}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat == "block":
        return functools.partial(checkpoint, body, use_reentrant=False)
    policy = functools.partial(_save_named, SAVED_NAMES[cfg.remat])
    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(policy))


def _unstack(tree, n: int) -> list:
    """The ``n`` periods of a stacked slot tree, one ``unbind`` a leaf (its
    backward stacks the grads once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _cross_kv(enc_out, p: dict, cfg: ModelConfig, axes):
    """A decoder block's cross K/V, projected from the encoder's output
    inside the block (and its remat), as JAX's ``block_enc_kv`` does."""
    if enc_out is None or "cross" not in p:
        return None
    kv_ax = axes.tp(cfg.n_kv_heads) if axes else None
    wk = L.uw(p["cross"]["wk"], axes, None, kv_ax, None, fsdp_dim=0)
    wv = L.uw(p["cross"]["wv"], axes, None, kv_ax, None, fsdp_dim=0)
    return (torch.einsum("bsd,dhe->bshe", enc_out, wk),
            torch.einsum("bsd,dhe->bshe", enc_out, wv))


def _run_stack(cfg: ModelConfig, axes, split, tree: dict, x, positions,
               aux, enc_out=None):
    """JAX's ``_scan_stack``: the stacked periods of ``split`` in order,
    each under :func:`_remat`, then the tail blocks."""
    n_periods, period, tail = split
    for kind, p in zip(cfg.lead_kinds(), tree.get("lead", ())):
        x, aux = _apply_block(kind, p, x, cfg, axes, positions, aux,
                              _cross_kv(enc_out, p, cfg, axes))

    def body(xc, auxc, bp, enc):
        for si, kind in enumerate(period):
            p = bp[f"s{si}"]
            xc, auxc = _apply_block(kind, p, xc, cfg, axes, positions, auxc,
                                    _cross_kv(enc, p, cfg, axes))
        return xc, auxc

    body = _remat(body, cfg)
    slots = {k: _unstack(t, n_periods) for k, t in tree["blocks"].items()}
    for i in range(n_periods):
        x, aux = body(x, aux, {k: v[i] for k, v in slots.items()}, enc_out)
    for kind, p in zip(tail, tree["tail"]):
        x, aux = _apply_block(kind, p, x, cfg, axes, positions, aux,
                              _cross_kv(enc_out, p, cfg, axes))
    return x, aux


def on_mesh(tree, axes, *others):
    """``tree`` with every plain tensor leaf replicated on the mesh of the
    call (``axes`` set); ``tree`` itself with ``axes=None``."""
    if axes is None:
        return tree
    leaves = []
    tree_map(leaves.append, (tree, others))
    mesh = L.mesh_of(*leaves)
    return tree_map(lambda t: L.replicate(t, mesh)
                    if isinstance(t, torch.Tensor) else t, tree)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, axes=None
           ) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, S_enc, D)."""
    frames = on_mesh(frames, axes, params)
    enc = params["encoder"]
    x = torch.einsum("bsd,de->bse", frames.to(cfg.param_dtype),
                     enc["adapter"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _run_stack(cfg, axes, _encoder_split(cfg), enc, x, positions,
                      None)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            axes=None, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward -> (logits (B, S, Vp), aux_loss scalar).

    ``return_hidden=True`` returns final hidden states instead of logits.
    batch: tokens (B, S_text); optional 'frontend' (B, n_front, D) patch
    embeddings (VLM); 'frames' (B, S_enc, D) audio frames (enc-dec), whose
    encoding each decoder block projects to its cross K/V. The MoE aux
    loss sums over the MoE blocks (float32 zero for the other families).
    Under autograd each period of blocks is recomputed in backward when
    ``cfg.remat == "block"`` (JAX's default), the encoder's too.
    """
    check_supported(cfg, axes)
    params = on_mesh(params, axes, batch)
    batch = on_mesh(batch, axes, params)
    x = L.embed(params["embed"], batch["tokens"], cfg, axes)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(params, batch["frames"], cfg, axes)
    if cfg.frontend == "vision_stub":
        fr = torch.einsum("bsd,de->bse", batch["frontend"].to(x.dtype),
                          params["frontend"]["adapter"])
        x = torch.cat([fr, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = on_mesh(torch.zeros((), dtype=torch.float32, device=x.device),
                  axes, x)
    x, aux = _run_stack(cfg, axes, cfg.pattern_split(), params, x,
                        positions, aux, enc_out)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux
    return L.logits(params["embed"], x, cfg, axes), aux


# ---------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
               enc_len: int = 0, device=None) -> dict:
    """Decode cache tree mirroring the block structure, zeros on
    ``device`` (the caller resolves it): K/V of ``s_max`` positions for an
    attention block (and cross K/V of ``enc_len`` for enc-dec), the
    recurrent state of an SSD or RG-LRU block. For the mesh path
    ``sharding.cache_pspecs`` lays it out (``distribute``)."""
    check_supported(cfg)
    dtype = dtype or cfg.param_dtype
    n_periods, period, tail = cfg.pattern_split()

    def one(kind, n=None):
        if kind == "ssd":
            c = S.init_mamba_cache(cfg, batch, dtype, device)
        elif kind == "recurrent":
            c = R.init_rglru_cache(cfg, batch, dtype, device)
        elif kind == "mla":
            c = {"c": torch.zeros((batch, s_max, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
                 "k_pe": torch.zeros((batch, s_max, cfg.qk_rope_head_dim),
                                     dtype=dtype, device=device)}
        else:
            kv = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
            c = {"k": torch.zeros(kv, dtype=dtype, device=device),
                 "v": torch.zeros(kv, dtype=dtype, device=device)}
            if cfg.family == "encdec":
                ckv = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
                c["ck"] = torch.zeros(ckv, dtype=dtype, device=device)
                c["cv"] = torch.zeros(ckv, dtype=dtype, device=device)
        if n is None:
            return c
        return {k: t.expand(n, *t.shape).clone() for k, t in c.items()}

    out = {"blocks": {f"s{si}": one(kind, n_periods)
                      for si, kind in enumerate(period)},
           "tail": [one(kind) for kind in tail]}
    if cfg.first_dense_layers:
        out["lead"] = [one(kind) for kind in cfg.lead_kinds()]
    return out


def _decode_block(kind: str, p: dict, c: dict, x, pos, cfg, axes,
                  tables=None, in_place: bool = False):
    """One block's decode step; ``tables``: the step's
    :func:`repro_torch.models.mla.decode_tables`, which every ``mla``
    block shares; ``in_place``: an ``mla`` block writes its latent cache
    in place."""
    if kind == "ssd":
        y, c2 = S.mamba_decode(
            p["mix"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), c, cfg, axes)
        return x + y, c2
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "recurrent":
        y, c2 = R.rglru_decode(p["rec"], h, c, cfg, axes)
    elif kind == "mla":
        y, lat, pe = A.mla_decode(p["attn"], h, c["c"], c["k_pe"], pos, cfg,
                                  tables, in_place)
        c2 = dict(c, c=lat, k_pe=pe)
    else:
        window = cfg.sliding_window if kind == "local" else None
        y, k2, v2 = L.decode_attention(p["attn"], h, c["k"], c["v"], pos,
                                       cfg, axes, window=window)
        c2 = dict(c, k=k2, v=v2)
    x = x + y
    if "cross" in p and "ck" in c:
        hc = L.rmsnorm(x, p["norm_c"], cfg.norm_eps)
        yc, _, _ = L.decode_attention(p["cross"], hc, c["ck"], c["cv"], pos,
                                      cfg, axes, cross=True)
        x = x + yc
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, _ = _ffn(p, h2, cfg, axes)
    return x + y, c2


def _write_prefix(cache, kv, axes):
    """A copy of ``cache`` (B, S_max, KV, dh) with ``kv`` (B, S, KV, dh)
    written at rows ``[0, S)``; under a mesh on each rank's slice of the
    cache (its batch or sequence shard)."""
    if axes is None:
        out = cache.clone()
        out[:, :kv.shape[1]] = kv.to(out.dtype)
        return out
    mesh = L.mesh_of(cache, kv)
    cache = L.replicate(cache, mesh)
    cpl = cache.placements
    kv = L.replicate(kv, mesh).redistribute(mesh, L._row_placements(cpl))
    out = cache.to_local().clone()
    off = L._seq_offset(mesh, cpl, out.shape[1])
    lo, hi = off, min(off + out.shape[1], kv.shape[1])
    if hi > lo:
        out[:, :hi - lo] = kv.to_local()[:, lo:hi].to(out.dtype)
    return L.from_local(out, mesh, cpl)


def _as_cache(state: dict, c: dict) -> dict:
    """A recurrent block's prefilled ``state`` in the dtypes of the cache
    ``c`` and, under a mesh, its placements."""
    out = {}
    for k, v in state.items():
        v = v.to(c[k].dtype)
        if hasattr(v, "placements") and v.placements != c[k].placements:
            v = v.redistribute(v.device_mesh, c[k].placements)
        out[k] = v
    return out


def _prefill_block(kind: str, p: dict, c: dict, x, positions, cfg, axes):
    """Full-sequence twin of :func:`_decode_block`: the block output for
    the whole prompt in parallel, plus the decode cache after it (K/V
    written at positions ``[0, S)``, as the per-token decode writes them:
    same projections and bias, RoPE at each position; the SSD and RG-LRU
    final states from their chunked and parallel scans)."""
    if kind == "ssd":
        y, st = S.mamba_apply(p["mix"],
                              L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
                              axes, return_state=True)
        return x + y, _as_cache(st, c)
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "recurrent":
        y, st = R.rglru_apply(p["rec"], h, cfg, axes, return_state=True)
        x = x + y
        c2 = _as_cache(st, c)
    elif kind == "mla":
        y, lat, pe = A.mla_attention(p["attn"], h, cfg, positions)
        x = x + y
        c2 = dict(c, c=_write_prefix(c["c"], lat, axes),
                  k_pe=_write_prefix(c["k_pe"], pe, axes))
    else:
        window = cfg.sliding_window if kind == "local" else None
        x = x + L.attention(p["attn"], h, cfg, axes, positions=positions,
                            causal=True, window=window)
        _, k, v = L.qkv_project(p["attn"], h, cfg, axes)
        cos, sin = L.rope_angles(positions, cfg.d_head, cfg.rope_theta)
        k = L.apply_rope(k, *on_mesh((cos, sin), axes, k))
        c2 = dict(c, k=_write_prefix(c["k"], k, axes),
                  v=_write_prefix(c["v"], v, axes))
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, _ = _ffn(p, h2, cfg, axes)
    return x + y, c2


def prefill_with_cache(params, cache: dict, tokens: torch.Tensor,
                       cfg: ModelConfig, axes=None
                       ) -> Tuple[torch.Tensor, dict]:
    """Single full-sequence prefill that also fills the decode cache.

    tokens (B, S) -> (last-position logits (B, 1, Vp), a new cache filled
    through position S): one parallel forward instead of S sequential
    ``decode_step`` calls, after which generation continues with
    ``decode_step`` at position S. The cache given is not written.
    Decoder-only families; enc-dec prefill goes through
    ``serve.engine.prefill_encdec_cache``.
    """
    check_supported(cfg, axes)
    if cfg.family == "encdec":
        raise NotImplementedError(
            "prefill_with_cache covers decoder-only families; use "
            "prefill_encdec_cache + decode_step for enc-dec models")
    params = on_mesh(params, axes, cache, tokens)
    cache = on_mesh(cache, axes, params)
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg, axes)
    positions = torch.arange(s, device=x.device)[None, :]
    new = {}
    for kind, p, c, slot in _layers(cfg, params, cache):
        x, new[slot] = _prefill_block(kind, p, c, x, positions, cfg, axes)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(params["embed"], x[:, -1:, :], cfg, axes)
    return lg, _gather_cache(cfg, new)


def decode_step(params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, axes=None, in_place: bool = False
                ) -> Tuple[torch.Tensor, dict]:
    """One decoding step: tokens (B, 1), pos (B,) -> (logits (B, 1, Vp),
    a new cache). Where the model has an attention cache, every ``pos``
    must lie inside it (:func:`check_positions`, one host read of
    ``pos``); JAX's dynamic-update-slice would clamp it silently. A model
    with recurrent state only bounds no position, as in JAX; nor does an
    abstract call, whose ``pos`` has no values (``meta``).

    ``in_place`` (latent-attention models, no mesh): the cache given is
    written and returned, and ``pos`` is not read on the host, as a
    captured CUDA graph needs (``serve.engine.make_decode_step(...,
    graph=True)``); the caller bounds it with :func:`check_positions`."""
    check_supported(cfg, axes)
    _, period, tail = cfg.pattern_split()
    if in_place and (axes is not None or set(
            cfg.lead_kinds() + period + tail) != {"mla"}):
        raise NotImplementedError(
            "an in-place decode step covers latent-attention (MLA) blocks "
            "without a mesh only")
    if not in_place:
        check_positions(cache, pos, cfg)
    params = on_mesh(params, axes, cache, tokens)
    cache = on_mesh(cache, axes, params)
    x = L.embed(params["embed"], tokens, cfg, axes)
    tables = None
    if cfg.mla:
        tables = A.decode_tables(pos, cfg, x.dtype)
    new = {}
    for kind, p, c, slot in _layers(cfg, params, cache):
        x, new[slot] = _decode_block(kind, p, c, x, pos, cfg, axes, tables,
                                     in_place)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(params["embed"], x, cfg, axes)
    return lg, (cache if in_place else _gather_cache(cfg, new))


def check_positions(cache: dict, pos: torch.Tensor, cfg: ModelConfig
                    ) -> None:
    """Raise unless every ``pos`` lies inside the cache's attention
    positions (one host read of ``pos``), where it has any and ``pos``
    has values; with a latent cache, also count the step's latent
    positions (:func:`repro_torch.models.mla.count_positions`)."""
    s_max = _cache_len(cache)
    if s_max is None or pos.is_meta:
        return
    at = pos.tolist()
    if min(at) < 0 or max(at) >= s_max:
        raise ValueError(f"decode position {at} outside the "
                         f"cache of {s_max} positions")
    if cfg.mla:
        A.count_positions(at)


#: The leaves of a block's cache that hold one entry a position: an
#: attention block's keys, a latent-attention block's latents.
_POSITION_LEAVES = ("k", "c")


def _cache_len(cache: dict) -> Optional[int]:
    """S_max of a cache tree: the sequence axis of its first attention
    cache (keys, or latents), stacked slots first, then the tail and the
    leading blocks (None when it holds none)."""
    for stacked, group in ((True, cache["blocks"].values()),
                           (False, cache["tail"]),
                           (False, cache.get("lead", ()))):
        for c in group:
            for leaf in _POSITION_LEAVES:
                if leaf in c:
                    return c[leaf].shape[2 if stacked else 1]
    return None
