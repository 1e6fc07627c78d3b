"""Model building blocks on tensors — the port of ``repro.models.layers``:
norms, RoPE, GQA attention (chunked flash, sliding window, decode,
context-parallel decode), MLPs, embeddings, and the sharding hooks.

Everything is functional: ``init_*`` returns param dicts drawn from an
explicit ``torch.Generator`` (on the generator's device), the apply
functions map (params, activations) -> activations and run where their
tensors lie.

Sharding. With ``axes=None`` every tensor is a plain tensor and the
models run unsharded. With an :class:`Axes`, params and activations are
DTensors on one ``DeviceMesh`` (a plain tensor counts as replicated on
it), and the hooks are JAX's: :func:`sc` redistributes an activation to a
spec's placements (``with_sharding_constraint``); :func:`uw` unshards an
FSDP-stored weight to its use layout, and DTensor's redistribute backward
sends the weight gradient back to the stored layout as a reduce-scatter,
as JAX's custom VJP does. Where DTensor has no sharding rule for an op
(the flash ``autograd.Function``, the embedding gather, the vocab-sharded
loss, the cache writes, the context-parallel merge) the code runs on
``to_local()`` slices with placements it states, and on explicit
functional collectives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.flash import flash_attention
from repro_torch.sharding.specs import P, to_placements


# ---------------------------------------------------------------- sharding
@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical -> physical mesh axis mapping (DESIGN.md §6)."""

    batch: Tuple[str, ...] = ("data",)    # ("pod", "data") on multi-pod
    model: str = "model"                  # TP / EP / vocab axis
    fsdp: str = "data"                    # param/optimizer shard axis
    seq: Optional[str] = None             # context-parallel axis for caches
    sizes: Optional[Tuple[Tuple[str, int], ...]] = None   # mesh axis sizes

    def tp(self, dim: int) -> Optional[str]:
        """'model' iff dim divides the TP degree (sharding/specs.py rule)."""
        size = dict(self.sizes or ()).get(self.model, 1)
        return self.model if size > 1 and dim % size == 0 else None


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, else the ambient mesh
    (``launch.mesh.set_mesh``)."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    from repro_torch.launch.mesh import get_abstract_mesh

    mesh = get_abstract_mesh()
    if mesh is None:
        raise ValueError("sharded call with no DTensor argument and no "
                         "ambient mesh (launch.mesh.set_mesh)")
    return mesh


def replicate(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor, which every rank
    holds whole, is replicated; a DTensor is returned as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _GradAs(torch.autograd.Function):
    """Identity whose gradient is laid out as its input: the cotangent
    half of a sharding constraint."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def sc(x, axes: Optional[Axes], *spec):
    """Sharding constraint when running under a mesh; no-op otherwise. As
    JAX's ``with_sharding_constraint``, it places the value and its
    gradient: DTensor's redistribute alone would hand a partial-sum
    gradient back unreduced, and the ops behind it would then gather their
    weights instead (the gradient of a residual stream, partial over the
    model axis after a TP block, is all-reduced here). A dim that its mesh
    axes do not divide stays replicated (:func:`even_placements`)."""
    if axes is None:
        return x
    mesh = mesh_of(x)
    x = replicate(x, mesh)
    y = x.redistribute(mesh, even_placements(P(*spec), x.shape, mesh))
    return _GradAs.apply(y) if y.requires_grad else y


def even_placements(spec, shape, mesh) -> tuple:
    """``to_placements(spec, mesh)`` for an activation of ``shape``, each
    dim sharded only over the mesh axes of its entry whose sizes' product
    divides it, the major axes dropped first: a microbatch of 16 rows over
    ("pod", "data") = 32 shards over "data" alone, a batch of one stays
    replicated. JAX pads an uneven shard; DTensor's view rules refuse
    one."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    fit = []
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        while names and shape[d] % math.prod(int(sizes.get(a, 1))
                                             for a in names):
            names = names[1:]
        fit.append(names or None)
    return to_placements(P(*fit), mesh)


def uw(w, axes: Optional[Axes], *spec, fsdp_dim: Optional[int] = None):
    """Unshard-at-use for an FSDP-stored weight (EXPERIMENTS.md §Perf
    hillclimb): the weight, stored sharded over the fsdp axis, is
    redistributed to its TP-only use layout (an all-gather) right before
    the contraction. DTensor's redistribute backward returns the weight
    gradient to the stored placements, a reduce-scatter from the partial
    sums; ``fsdp_dim`` (which JAX needs to rebuild the stored spec) is
    kept for the signature, the DTensor carrying its stored layout."""
    del fsdp_dim
    if axes is None:
        return w
    mesh = mesh_of(w)
    return replicate(w, mesh).redistribute(mesh,
                                           to_placements(P(*spec), mesh))


def batch_spec(axes: Optional[Axes]):
    return axes.batch if axes else None


def local(x: DTensor, partial_dims: Sequence[int] = ()) -> torch.Tensor:
    """``x.to_local()``; its gradient is a partial sum over the mesh dims
    ``partial_dims`` (where ``x`` is replicated but its use is sharded),
    and keeps ``x``'s placements elsewhere."""
    if not partial_dims:
        return x.to_local()
    grads = [Partial() if i in partial_dims else pl
             for i, pl in enumerate(x.placements)]
    return x.to_local(grad_placements=grads)


def from_local(t: torch.Tensor, mesh, placements, shape=None) -> DTensor:
    """A DTensor of this rank's ``t``; ``shape``, where given, is its
    global shape (a batch sharded unevenly, one row over many ranks, has
    no other way to say it)."""
    if shape is None:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= max(int(size), 1)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _shard_dims(placements, dim: int) -> list:
    return [i for i, pl in enumerate(placements)
            if pl.is_shard() and pl.dim == dim]


def with_placement(placements, dim: Optional[int], pl) -> tuple:
    """``placements`` with mesh dim ``dim`` set to ``pl`` (unchanged for
    ``dim=None``)."""
    out = list(placements)
    if dim is not None:
        out[dim] = pl
    return tuple(out)


def model_split(mesh, axes: Axes, n: int) -> Tuple[Optional[int], int, int]:
    """(model mesh dim, TP degree, this rank's index along it) when ``n``
    (heads, experts, channels) is split over the model axis (``axes.tp``);
    ``(None, 1, 0)`` when every model rank holds all ``n``."""
    if axes.tp(n) is None:
        return None, 1, 0
    names = tuple(mesh.mesh_dim_names or ())
    m = names.index(axes.model) if axes.model in names else None
    if m is None or mesh.size(m) != dict(axes.sizes)[axes.model]:
        raise ValueError(f"axes {axes} do not describe the mesh "
                         f"{tuple(mesh.mesh_dim_names)} of "
                         f"{tuple(mesh.mesh.shape)}")
    return m, mesh.size(m), mesh.get_local_rank(m)


def whole(w, axes: Axes, partial_dims: Sequence[int] = ()) -> torch.Tensor:
    """Weight ``w`` unsharded whole at use (:func:`uw` to every mesh dim
    replicated: all-gathers of its stored shards) as this rank's tensor;
    its gradient a partial sum over the mesh dims ``partial_dims`` (where
    the ranks use it on different rows or take different slices of it),
    which the backward of ``uw`` reduce-scatters onto the stored layout."""
    return local(uw(w, axes, *([None] * w.ndim)), partial_dims)


def _all_reduce(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        t = funcol.all_reduce(t, "sum", (mesh, d))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims, split_use):
        ctx.mesh, ctx.dims, ctx.split_use = mesh, dims, split_use
        return _all_reduce(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        if ctx.split_use:
            g = _all_reduce(g, ctx.mesh, ctx.dims)
        return g, None, None, None


def psum(t: torch.Tensor, mesh, dims: Sequence[int],
         split_use: bool = False) -> torch.Tensor:
    """JAX's ``psum`` of this rank's ``t`` over the mesh dims ``dims``: one
    all-reduce a dim of more than one rank. Its backward is the identity
    when every rank uses the sum whole (the gradient arrives whole on
    each), an all-reduce too when ``split_use`` (each rank uses it on its
    own slice, so holds a partial gradient)."""
    dims = tuple(d for d in dims if mesh.size(d) > 1)
    if not dims:
        return t
    return _PSum.apply(t, mesh, dims, split_use)


def split_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, n: int,
                  mesh=None, dims: Sequence[int] = ()) -> torch.Tensor:
    """:func:`rmsnorm` of a last dim of ``n`` split over the mesh dims
    ``dims`` (this rank's ``x`` and ``scale`` its slice): each row's sum
    of squares is all-reduced, (B, S) floats, and every rank normalises
    its slice. With no dim split it is :func:`rmsnorm`."""
    if mesh is None or not any(mesh.size(d) > 1 for d in dims):
        return rmsnorm(x, scale, eps)
    x32 = x.float()
    ss = psum(x32.square().sum(dim=-1, keepdim=True), mesh, dims,
              split_use=True)
    out = x32 * torch.rsqrt(ss / n + eps)
    return (out * scale.float()).to(x.dtype)


@torch.library.custom_op("repro_torch::tag", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


def _tag_bwd(ctx, g):
    return g, None


_tag.register_autograd(_tag_bwd)

TAG_OP = torch.ops.repro_torch.tag.default


def checkpoint_name(x, name: str):
    """JAX's ``checkpoint_name``: ``x`` through an identity op that carries
    ``name``, which the remat policies of ``transformer._remat`` save
    (``attn_out``, ``moe_out``) while they recompute the rest."""
    if isinstance(x, DTensor):
        return from_local(TAG_OP(x.to_local(), name), x.device_mesh,
                          x.placements, shape=x.shape)
    return TAG_OP(x, name)


# ------------------------------------------------------------------- utils
def dense_init(gen: torch.Generator, in_dim: int, out_dims,
               dtype: torch.dtype) -> torch.Tensor:
    shape = ((in_dim, *out_dims) if isinstance(out_dims, tuple)
             else (in_dim, out_dims))
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    # A bfloat16 scale is upcast inside the product: no launch of its own.
    return (out * scale).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., d_head/2)."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, dh); cos/sin (..., S, dh/2) broadcast over heads. The
    tables are cast to ``x``'s dtype before the products, as JAX does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------- attention
def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, d, (h, dh), dtype),
        "wk": dense_init(gen, d, (kv, dh), dtype),
        "wv": dense_init(gen, d, (kv, dh), dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((heads, dh), dtype=dtype,
                                  device=gen.device)
    return p


def qkv_project(p: dict, x: torch.Tensor, cfg, axes: Optional[Axes] = None):
    """x (B, S, D) -> q (B, S, H, dh), k/v (B, S, KV, dh)."""
    h_ax = axes.tp(cfg.n_heads) if axes else None
    kv_ax = axes.tp(cfg.n_kv_heads) if axes else None
    q = torch.einsum("bsd,dhe->bshe", x,
                     uw(p["wq"], axes, None, h_ax, None, fsdp_dim=0))
    k = torch.einsum("bsd,dhe->bshe", x,
                     uw(p["wk"], axes, None, kv_ax, None, fsdp_dim=0))
    v = torch.einsum("bsd,dhe->bshe", x,
                     uw(p["wv"], axes, None, kv_ax, None, fsdp_dim=0))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if axes:
        q = sc(q, axes, axes.batch, None, h_ax, None)
    return q, k, v


def _pick_chunk(sk: int, want: int) -> Optional[int]:
    """Largest power-of-two-ish divisor of sk ≤ want (flash needs even
    chunking); None if sk has no usable divisor."""
    c = min(want, sk)
    while c > 1 and sk % c:
        c //= 2
    return c if sk % c == 0 else None


def attention(
    p: dict,
    x: torch.Tensor,
    cfg,
    axes: Optional[Axes] = None,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Multi-head GQA attention over a full sequence (train / prefill).

    ``window`` enables sliding-window masking (local layers);
    ``kv_override`` supplies external K/V (cross-attention) — no RoPE is
    applied to overridden KV and causality is disabled. Both of JAX's
    ``attn_impl`` values compute one function, the chunked online softmax;
    the port runs :func:`repro_torch.models.flash.flash_attention` for
    both, at JAX's ``flash_vjp`` chunking. Under a mesh flash runs on each
    rank's slice (:func:`_sharded_flash`).
    """
    b, s, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = qkv_project(p, x, cfg, axes)
    if kv_override is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = rope_angles(positions, dh, cfg.rope_theta)
        if axes is not None:
            mesh = mesh_of(q)
            cos, sin = replicate(cos, mesh), replicate(sin, mesh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv_override
        causal = False
    chunk = _pick_chunk(k.shape[1], cfg.attn_chunk)
    scale = 1.0 / math.sqrt(dh)
    if axes is None:
        o = flash_attention(q.reshape(b, s, kvh, h // kvh, dh), k, v,
                            causal, window, chunk, scale).float()
    else:
        o = _sharded_flash(q, k, v, axes, causal, window, chunk, scale)
    o = o.reshape(b, s, h * dh).to(x.dtype)
    h_ax = axes.tp(h) if axes else None
    # JAX's einsum "bshe,hed->bsd" as one (h·dh) contraction: under a mesh
    # the heads shard the leading part of the flattened dim, which every
    # torch version's view rule keeps sharded.
    out = torch.matmul(o, uw(p["wo"], axes, h_ax, None, fsdp_dim=1))
    out = sc(out, axes, axes.batch if axes else None, None, None)
    # Named so remat="block_save" keeps this post-all-gather tensor instead
    # of re-running the attention (and its seq-shard exit AG) in backward.
    return checkpoint_name(out, "attn_out")


def _sharded_flash(q, k, v, axes: Axes, causal, window, chunk, scale):
    """Flash attention of DTensors q (B, S, H, dh) and k/v (B, Sk, KV, dh)
    on each rank's slice -> (B, S, H, dh) DTensor in q's dtype.

    Batch shards over ``axes.batch``; heads over the model axis when they
    divide it, else (JAX's sequence-sharded branch, :243-258 of
    ``repro.models.layers``) the query sequence does, each rank's queries
    at their global positions. K/V keep their heads sharded only where the
    KV heads divide the model axis; otherwise they are replicated there and
    each rank takes the KV heads its query heads read, its K/V gradient a
    partial sum over the model axis."""
    mesh = q.device_mesh
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    h_ax = axes.tp(h)
    kv_ax = axes.tp(kvh) if h_ax else None
    tp = dict(axes.sizes or ()).get(axes.model, 1)
    seq_shard = h_ax is None and tp > 1 and s % tp == 0
    q = q.redistribute(mesh, even_placements(
        P(axes.batch, axes.model if seq_shard else None, h_ax, None),
        q.shape, mesh))
    kpl = even_placements(P(axes.batch, None, kv_ax, None), k.shape, mesh)
    k, v = replicate(k, mesh), replicate(v, mesh)
    k, v = k.redistribute(mesh, kpl), v.redistribute(mesh, kpl)
    partial = [i for i, (a, c) in enumerate(zip(q.placements, kpl))
               if a.is_shard() and not c.is_shard()]
    ql, kl, vl = q.to_local(), local(k, partial), local(v, partial)
    r = (mesh.get_local_rank(axes.model)
         if axes.model in mesh.mesh_dim_names else 0)
    bl, sl, hl, _ = ql.shape
    q0 = r * sl if seq_shard else 0
    if h_ax is not None and kv_ax is None:
        g, lo = h // kvh, r * hl
        if hl % g == 0:
            kl, vl = (t[:, :, lo // g:(lo + hl) // g] for t in (kl, vl))
        elif g % hl == 0:
            kl, vl = (t[:, :, lo // g:lo // g + 1] for t in (kl, vl))
        else:
            idx = torch.div(lo + torch.arange(hl, device=kl.device), g,
                            rounding_mode="floor")
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    kvl = kl.shape[2]
    qg = ql.reshape(bl, sl, kvl, hl // kvl, dh)
    ol = flash_attention(qg, kl, vl, causal, window, chunk, scale, q0)
    return from_local(ol.reshape(bl, sl, hl, dh), mesh, q.placements,
                      shape=q.shape)


def decode_attention(
    p: dict,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    cfg,
    axes: Optional[Axes] = None,
    *,
    window: Optional[int] = None,
    cross: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache.

    x (B, 1, D); caches (B, S_max, KV, dh); pos (B,) current positions.
    Returns (out, new_k_cache, new_v_cache); the caches given are not
    written. ``cross=True`` (enc-dec) reads the whole prefilled encoder
    cache: no K/V write, no RoPE, and every row attended (an empty cache
    gives zeros). With ``axes.seq`` set, the cache is sequence-sharded
    and the softmax is combined across the context-parallel axis with an
    exact flash merge (:func:`_cp_decode_attend`, DESIGN.md §6).
    """
    if axes is not None:
        return _sharded_decode_attention(p, x, k_cache, v_cache, pos, cfg,
                                         axes, window, cross)
    b, _, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_max = k_cache.shape[1]
    if cross:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
    else:
        q, k, v = qkv_project(p, x, cfg)
        cos, sin = rope_angles(pos[:, None], dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = _cache_insert(k_cache, k, pos)
        v_cache = _cache_insert(v_cache, v, pos)
    qg = q.reshape(b, kvh, h // kvh, dh)
    attend_pos = torch.full_like(pos, s_max) if cross else pos
    out = _decode_attend(qg, k_cache, v_cache, attend_pos, window, dh,
                         torch.arange(s_max, device=x.device))
    o = out.reshape(b, 1, h * dh).to(x.dtype)
    return (torch.einsum("bsf,fd->bsd", o, p["wo"].reshape(h * dh, d)),
            k_cache, v_cache)


def _row_placements(cache_placements):
    """Placements of a per-row (B, ...) activation beside a cache laid out
    by ``cache_placements``: the cache's batch shards, replicated
    elsewhere."""
    return tuple(pl if pl.is_shard() and pl.dim == 0 else Replicate()
                 for pl in cache_placements)


def _seq_offset(mesh, cache_placements, s_local: int) -> int:
    """The first global row of this rank's slice of a cache whose sequence
    dim is sharded by ``cache_placements`` (0 when it is not)."""
    dims = _shard_dims(cache_placements, 1)
    if len(dims) > 1:
        raise ValueError("a cache sequence sharded over more than one mesh "
                         "dim")
    return mesh.get_local_rank(dims[0]) * s_local if dims else 0


def _decode_project(x, w, bias, mesh, rpl) -> torch.Tensor:
    """This rank's rows (``rpl``) of x (B, 1, D) times w (D, H, dh) (+
    bias (H, dh)), as one matmul over the flattened heads through DTensor
    (JAX's einsum on the stored weights): the product is laid out as the
    cache's rows before the heads are split out of it, since DTensor may
    shard the flattened dim over the model axis in pieces that heads not
    dividing that axis cannot follow."""
    d, hh, dh = w.shape
    y = torch.matmul(x, w.reshape(d, hh * dh))
    if bias is not None:
        y = y + bias.reshape(hh * dh)
    return y.redistribute(mesh, rpl).to_local().reshape(-1, 1, hh, dh)


def _sharded_decode_attention(p, x, k_cache, v_cache, pos, cfg, axes,
                              window, cross):
    """:func:`decode_attention` on DTensors: the projections through
    DTensor (:func:`_decode_project`), the cache write and the scores on
    each rank's slice (the cache's batch or sequence shard; heads
    replicated)."""
    mesh = mesh_of(k_cache, x)
    b, _, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = replicate(x, mesh)
    k_cache, v_cache = replicate(k_cache, mesh), replicate(v_cache, mesh)
    cpl = k_cache.placements
    rpl = _row_placements(cpl)
    pos_l = replicate(pos, mesh).redistribute(mesh, rpl).to_local()

    def project(name):
        bias = p["b" + name[1]] if cfg.qkv_bias else None
        return _decode_project(x, p[name], bias, mesh, rpl)

    q = project("wq")
    if cross:
        full = tuple(Replicate() if pl.is_shard() and pl.dim == 1 else pl
                     for pl in cpl)
        kc = k_cache.redistribute(mesh, full).to_local()
        vc = v_cache.redistribute(mesh, full).to_local()
        s_max = kc.shape[1]
        out = _decode_attend(q.reshape(-1, kvh, h // kvh, dh), kc, vc,
                             torch.full_like(pos_l, s_max), window, dh,
                             torch.arange(s_max, device=kc.device))
    else:
        k, v = project("wk"), project("wv")
        cos, sin = rope_angles(pos_l[:, None], dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc, vc = k_cache.to_local(), v_cache.to_local()
        off = _seq_offset(mesh, cpl, kc.shape[1])
        kc = _cache_insert_local(kc, k, pos_l, off)
        vc = _cache_insert_local(vc, v, pos_l, off)
        k_cache = from_local(kc, mesh, cpl)
        v_cache = from_local(vc, mesh, cpl)
        qg = q.reshape(-1, kvh, h // kvh, dh)
        if axes.seq is not None and _shard_dims(cpl, 1):
            out = _cp_decode_attend(qg, k_cache, v_cache, pos_l, window, dh,
                                    axes)
        else:
            out = _decode_attend(qg, kc, vc, pos_l, window, dh,
                                 torch.arange(kc.shape[1], device=kc.device))
    o = from_local(out.reshape(-1, 1, h * dh).to(x.dtype), mesh, rpl)
    return (torch.einsum("bsf,fd->bsd", o, p["wo"].reshape(h * dh, d)),
            k_cache, v_cache)


def _cache_insert(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor,
                  in_place: bool = False):
    """A copy of ``cache`` with (B, 1, KV, dh) written at per-batch
    position ``pos`` (B,), or ``cache`` itself so written (``in_place``).
    JAX's dynamic-update-slice clamps a position past the end; here the
    caller checks ``pos < S_max``
    (:func:`repro_torch.models.transformer.check_positions`), and an
    index past the end raises rather than landing on the last row."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    put = cache.index_put_ if in_place else cache.index_put
    return put((rows, pos.long()), kv[:, 0].to(cache.dtype))


def _cache_insert_local(cache: torch.Tensor, kv: torch.Tensor,
                        pos: torch.Tensor, offset: int) -> torch.Tensor:
    """:func:`_cache_insert` into one rank's slice of rows ``[offset,
    offset + S_local)``: a row outside the slice is left as it is (no
    host read of ``pos``)."""
    s_loc = cache.shape[1]
    idx = pos.long() - offset
    inside = (idx >= 0) & (idx < s_loc)
    idx = idx.clamp(0, s_loc - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    new = torch.where(inside[:, None, None], kv[:, 0].to(cache.dtype),
                      cache[rows, idx])
    return cache.index_put((rows, idx), new)


def _decode_attend(qg, k_cache, v_cache, pos, window, dh, k_positions):
    """qg (B, KV, G, dh) vs cache (B, S, KV, dh) -> (B, KV, G, dh)."""
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float() * scale, k_cache.float())
    valid = k_positions[None, :] <= pos[:, None]
    if window is not None:
        valid &= k_positions[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p_ = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p_, v_cache.float())


def _cp_decode_attend(qg, k_cache, v_cache, pos, window, dh, axes: Axes):
    """Context-parallel decode: the cache's sequence dim is sharded over
    ``axes.seq``. Each rank scores ``qg`` (B, KV, G, dh, this rank's rows)
    against its shard, at global key positions offset by its rank along
    the axis, and the exact softmax comes from a max all-reduce and sum
    all-reduces of the corrected sums ``l`` and outputs ``o`` (JAX's
    ``pmax``/``psum`` flash merge under ``shard_map``). The mesh is the
    ambient one (``launch.mesh.set_mesh``), else the cache's."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.launch.mesh import get_abstract_mesh

    mesh = get_abstract_mesh()
    if mesh is None:
        mesh = k_cache.device_mesh
    dim = mesh.mesh_dim_names.index(axes.seq)
    kc, vc = k_cache.to_local(), v_cache.to_local()
    s_shard = kc.shape[1]
    k_positions = (mesh.get_local_rank(dim) * s_shard
                   + torch.arange(s_shard, device=kc.device))
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float() * scale, kc.float())
    valid = k_positions[None, :] <= pos[:, None]
    if window is not None:
        valid &= k_positions[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m_loc = s.amax(dim=-1)
    p_ = torch.exp(s - m_loc[..., None])
    l_loc = p_.sum(dim=-1)
    o_loc = torch.einsum("bkgs,bskd->bkgd", p_, vc.float())
    group = (mesh, dim)
    m = funcol.all_reduce(m_loc, "max", group)
    corr = torch.exp(m_loc - m)
    l = funcol.all_reduce(l_loc * corr, "sum", group)
    o = funcol.all_reduce(o_loc * corr[..., None], "sum", group)
    return o / l.clamp_min(1e-30)[..., None]


# -------------------------------------------------------------------- MLP
def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """JAX's ``jax.nn.gelu`` defaults to the tanh form; torch's to erf."""
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    return F.silu(h)


def init_mlp(gen: torch.Generator, cfg, dtype,
             d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {
            "wi": dense_init(gen, d, f, dtype),
            "wg": dense_init(gen, d, f, dtype),
            "wo": dense_init(gen, f, d, dtype),
        }
    return {
        "wi": dense_init(gen, d, f, dtype),
        "wo": dense_init(gen, f, d, dtype),
    }


def mlp(p: dict, x: torch.Tensor, cfg, axes: Optional[Axes] = None
        ) -> torch.Tensor:
    f_ax = axes.tp(p["wi"].shape[-1]) if axes else None
    h = torch.einsum("bsd,df->bsf", x,
                     uw(p["wi"], axes, None, f_ax, fsdp_dim=0))
    if cfg.act == "silu":
        g = torch.einsum("bsd,df->bsf", x,
                         uw(p["wg"], axes, None, f_ax, fsdp_dim=0))
        h = F.silu(g) * h
    else:
        h = activation(h, cfg.act)
    h = sc(h, axes, axes.batch if axes else None, None, f_ax)
    out = torch.einsum("bsf,fd->bsd", h,
                       uw(p["wo"], axes, f_ax, None, fsdp_dim=1))
    # The residual stream stays batch-sharded and replicated over the
    # model axis: the TP partial sums are all-reduced here (where XLA's
    # propagation puts them), not carried into the next norm; and so is
    # the stream's gradient (sc).
    return sc(out, axes, axes.batch if axes else None, None, None)


# -------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg, dtype) -> dict:
    p = {"tok": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=gen.device) * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def embed(p: dict, tokens: torch.Tensor, cfg, axes: Optional[Axes] = None
          ) -> torch.Tensor:
    """Rows of the table times sqrt(d_model), in the table's dtype. Under
    a mesh the table is unsharded at use and each rank gathers the rows of
    its batch shard, its table gradient a partial sum over the batch
    axes."""
    if axes is None:
        return p["tok"][tokens] * math.sqrt(cfg.d_model)
    mesh = mesh_of(p["tok"], tokens)
    bpl = even_placements(P(axes.batch), tokens.shape, mesh)
    table = local(uw(p["tok"], axes), [i for i, pl in enumerate(bpl)
                                       if pl.is_shard()])
    tokens = replicate(tokens, mesh)
    tok = tokens.redistribute(mesh, bpl).to_local()
    return from_local(table[tok] * math.sqrt(cfg.d_model), mesh, bpl,
                      shape=(*tokens.shape, table.shape[1]))


def logits(p: dict, x: torch.Tensor, cfg, axes: Optional[Axes] = None
           ) -> torch.Tensor:
    table = p["tok"] if cfg.tie_embeddings else p["head"].T
    v_ax = axes.tp(table.shape[0]) if axes else None
    table = uw(table, axes, v_ax, None, fsdp_dim=1)
    out = torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))
    return sc(out, axes, axes.batch if axes else None, None, v_ax)
