"""Tree helpers over the port's params and train-state trees — the
counterpart of ``repro.common.pytree``.

The port's trees are dicts, lists and tuples of tensors (the params tree,
the optimizer state, a train state). The optimizer, the checkpoint store
and the train step walk them with these helpers. Leaves come in JAX's
flatten order (dict keys sorted, list indices in order), so a key path
names the same leaf in both packages and sums over leaves run in the same
order. JAX's ``pytree_dataclass`` and ``static_field`` register dataclasses
as JAX pytrees; torch needs no registration, so they have no counterpart
here. ``replace`` is ``dataclasses.replace``, as in JAX's module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

replace = dataclasses.replace


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of ``trees`` (same structure), keeping the
    first tree's containers and key order."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_map_n(fn: Callable, n: int, *trees) -> tuple:
    """``fn`` over the leaves of ``trees``, where it returns ``n`` values:
    ``n`` trees of the first tree's structure, one for each value (JAX's
    ``tree_map`` to tuples, then one ``tree_map`` per tuple slot)."""
    outs = []
    tree_map(lambda *xs: outs.append(fn(*xs)), *trees)
    parts = []
    for i in range(n):
        it = iter([o[i] for o in outs])
        parts.append(tree_map(lambda _: next(it), trees[0]))
    return tuple(parts)


def tree_leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs in JAX's flatten order: dict keys sorted,
    list and tuple entries in order. A path holds dict keys and list
    indices; an empty dict or list has no leaves."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in tree_leaves_with_path(x, prefix + (i,))]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(key path, leaf)`` over the leaves of ``tree``, keeping its
    containers."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, prefix + (i,))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def key_str(path: Tuple) -> str:
    """A key path as JAX's checkpoint store writes it: dict keys and list
    indices joined by ``/``."""
    return "/".join(str(p) for p in path)
