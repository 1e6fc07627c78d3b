"""Parameter and cache partition specs — the port of
``repro.sharding.specs``, with JAX's rules and leaf names.

Rules are keyed by leaf name; dimensions shard onto an axis only when
evenly divisible by that axis extent (heads that don't divide the TP degree
stay FSDP-only — e.g. llama3.2's 24 heads on a 16-wide model axis).
Leaves living under a stacked ``blocks`` slot get a leading ``None``.

:class:`P` holds what JAX's ``PartitionSpec`` holds: per tensor dim
``None``, a mesh axis name, or a tuple of names. On a torch
``DeviceMesh`` a spec becomes one DTensor placement per mesh dim
(:func:`to_placements`): ``Shard(d)`` on every mesh dim that tensor dim
``d`` names, ``Replicate()`` on the others. A tuple entry such as
``("pod", "data")`` shards one tensor dim over both mesh dims, the major
mesh dim first, as DTensor nests its shards in mesh-dim order.
:func:`named_shardings` turns a tree of specs into a tree of
:class:`NamedSharding` (mesh + spec), and :func:`distribute` lays a tree
of full tensors out by it; each rank keeps its own slice, with no
collective.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.pytree import tree_map, tree_map_with_path

MODEL = "model"
FSDP = "data"


class P:
    """A partition spec: per tensor dim ``None``, an axis name or a tuple
    of axis names (JAX's ``PartitionSpec``). It iterates, indexes and
    compares as the tuple of its entries, and is a leaf of the port's
    trees (``common.pytree`` descends into tuples, not into a spec)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        # As JAX's: a one-name tuple is the name, an empty one None.
        self.entries = tuple(
            (e[0] if len(e) == 1 else (tuple(e) or None))
            if isinstance(e, (tuple, list)) else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def _ax(dim: int, axis: str, sizes: Dict[str, int]) -> Optional[str]:
    size = sizes.get(axis, 1)
    return axis if size > 1 and dim % size == 0 else None


def leaf_spec(name: str, shape: Tuple[int, ...], sizes: Dict[str, int]) -> P:
    """PartitionSpec for one (unstacked) parameter leaf."""
    m = lambda d: _ax(d, MODEL, sizes)      # noqa: E731
    f = lambda d: _ax(d, FSDP, sizes)       # noqa: E731
    nd = len(shape)
    if nd <= 1:
        return P(None)
    if name == "tok":                               # (V, D)
        return P(m(shape[0]), f(shape[1]))
    if name == "head":                              # (D, V)
        return P(f(shape[0]), m(shape[1]))
    if name in ("wq", "wk", "wv"):                  # (D, H, dh)
        return P(f(shape[0]), m(shape[1]), None)
    if name in ("bq", "bk", "bv"):                  # (H, dh)
        return P(m(shape[0]), None)
    if name in ("wi", "wg"):
        if nd == 3:                                 # MoE (E, D, F)
            return P(m(shape[0]), f(shape[1]), None)
        return P(f(shape[0]), m(shape[1]))          # (D, F)
    if name == "wo":
        if nd == 3:                                 # MoE (E, F, D)
            return P(m(shape[0]), None, f(shape[2]))
        return P(m(shape[0]), f(shape[1]))          # (X, D)
    if name == "router":                            # (D, E)
        return P(f(shape[0]), None)
    if name in ("in_proj", "wx", "adapter"):        # (D, K)
        return P(f(shape[0]), m(shape[1]))
    if name == "out_proj":                          # (di, D)
        return P(m(shape[0]), f(shape[1]))
    if name in ("w_a", "w_i"):                      # (RW, RW)
        return P(None, m(shape[1]))
    if name == "conv_w":                            # (W, C)
        return P(None, m(shape[1]))
    # Fallback: replicate.
    return P(*([None] * nd))


def param_pspecs(params, mesh_axis_sizes: Dict[str, int]):
    """PartitionSpec tree matching ``params`` (tensors, meta tensors
    included: only shapes are read)."""

    def assign(path, leaf):
        name = str(path[-1])
        shape = tuple(leaf.shape)
        if "blocks" in path:
            return P(None, *leaf_spec(name, shape[1:], mesh_axis_sizes))
        return leaf_spec(name, shape, mesh_axis_sizes)

    return tree_map_with_path(assign, params)


def cache_pspecs(cache, batch_axes: Tuple[str, ...],
                 mesh_axis_sizes: Dict[str, int],
                 seq_shard: bool = False):
    """KV/recurrent cache specs.

    Default: batch over DP axes. ``seq_shard`` (context parallelism,
    long_500k) shards the cache *sequence* dim over the data axis instead.
    """

    def assign(path, leaf):
        name = str(path[-1])
        stacked = "blocks" in path
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if name in ("k", "v", "ck", "cv"):          # (B, S, KV, dh)
            if seq_shard:
                spec = P(None, FSDP, None, None)
            else:
                dp = 1
                for a in batch_axes:
                    dp *= mesh_axis_sizes.get(a, 1)
                spec = P(batch_axes if shape[0] % max(dp, 1) == 0 else None,
                         None, None, None)
        elif name == "h":                            # recurrent state (B, ...)
            spec = P(*([None] * len(shape)))
        elif name == "conv":                         # (B, W-1, C)
            spec = P(None, None, _ax(shape[2], MODEL, mesh_axis_sizes))
        else:
            spec = P(*([None] * len(shape)))
        if stacked:
            spec = P(None, *spec)
        return spec

    return tree_map_with_path(assign, cache)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh`` for ``spec``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names (a tuple
    entry names several, major first), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = []
        for n in names:
            if n not in dims:
                raise ValueError(f"spec {spec!r} names axis {n!r}; the mesh "
                                 f"has {tuple(dims)}")
            if not isinstance(out[dims.index(n)], Replicate):
                raise ValueError(f"spec {spec!r} uses axis {n!r} twice")
            idx.append(dims.index(n))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: tuple entry {names} must list "
                             f"mesh axes major first, as {tuple(dims)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are the
    DTensor placements it stands for."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def named_shardings(tree_specs, mesh):
    """A tree of :class:`NamedSharding`, one per spec of ``tree_specs``."""
    return tree_map(lambda s: NamedSharding(mesh, P(*s)), tree_specs)


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` holds its tensors on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """The DTensor of full tensor ``t`` laid out by ``sharding``, every
    rank holding ``t`` whole and keeping its own slice (no collective)."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements
    coord = mesh.get_coordinate()
    local = t
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does "
                                 f"not split {n} ways")
            local = local.chunk(n, dim=pl.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False)


def distribute(tree, shardings):
    """``tree`` of full tensors as DTensors by the matching ``shardings``
    tree (:func:`named_shardings`)."""
    return tree_map(shard_tensor, tree, shardings)
