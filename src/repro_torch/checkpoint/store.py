"""Checkpointing: flat-keyed npz shards + JSON manifest — the port of
``repro.checkpoint.store``, in JAX's format.

* save/restore the full train state (params, optimizer, step),
* async save (the host snapshot is taken before ``save`` returns, then a
  background thread writes it),
* restore places each leaf on the caller's device (JAX's ``shardings``).

Keys are JAX's: dict keys and list indices joined by ``/``; the npz holds
one array per leaf and ``manifest.json`` the step, the shard's name, the
sorted keys and ``extra``. A bfloat16 leaf is written as JAX writes it, a
2-byte void array (numpy has no bfloat16 without ``ml_dtypes``), and read
back by its bits; JAX's own ``restore`` cannot cast such a leaf (a known
difference of the reference, ``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.pytree import (
    key_str,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)
from repro_torch.kernels.ops import resolve_device

_BF16_BITS = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, even of a CPU tensor);
    bfloat16 as 2-byte voids."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """An array just read from the shard as a CPU tensor on its memory;
    2-byte voids as bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key_str(path): _host(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def save(directory: str, state, step: int,
         extra: Optional[Dict[str, Any]] = None):
    """Blocking save of ``state`` at ``step`` into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(state)
    shard_path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = shard_path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, shard_path)
    manifest = {
        "step": step,
        "shard": os.path.basename(shard_path),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    mtmp = os.path.join(directory, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))


def latest_step(directory: str) -> Optional[int]:
    mpath = os.path.join(directory, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)["step"]


def restore(directory: str, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors), each
    leaf in its ``like`` leaf's dtype, on ``device`` (default: the card).
    Returns (tree, manifest)."""
    dev = resolve_device(device)
    mpath = os.path.join(directory, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, manifest["shard"])) as data:
        def one(path, leaf):
            key = key_str(path)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape},"
                                 f" want {tuple(leaf.shape)}")
            return _tensor(arr).to(device=dev, dtype=leaf.dtype)

        return tree_map_with_path(one, like), manifest


class AsyncCheckpointer:
    """Snapshot-to-host then write in a background thread; ``wait()``
    blocks until the previous save lands (bounded staleness of 1)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None

    def save(self, state, step: int, extra=None):
        """Returns once every leaf is copied to the host: later writes to
        ``state``'s tensors, in place or not, do not reach the file."""
        self.wait()
        host_state = tree_map(_host, state)  # snapshot
        self._thread = threading.Thread(
            target=save, args=(self.directory, host_state, step, extra),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
