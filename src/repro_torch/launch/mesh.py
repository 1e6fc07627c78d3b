"""Device meshes — the port of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module starts no
process group. A mesh is a ``torch.distributed`` ``DeviceMesh`` over one
process group per process:

* ``device_type=None`` means the card: NCCL, raising when there is none;
  ``"cpu"`` means gloo (the tests' ranks).
* :func:`make_mesh` starts the group only if none is started: from the
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment that
  ``torchrun`` (or a test's spawner) sets, or, for a mesh of one device
  with no such environment, as a world of 1 on a free ``localhost`` port.
* :func:`make_production_mesh` is the 16×16 ``data×model`` pod (2×16×16
  ``pod×data×model`` for two pods) on torch's fake backend, one process
  standing for rank 0 of 256 or 512: the counterpart of JAX's
  ``--xla_force_host_platform_device_count=512``. Its collectives run no
  communication; the dry run (``launch/dryrun.py``) traces a step on it
  with tensors that hold no storage.
* :func:`shutdown` destroys the group; whoever made the mesh calls it.

JAX-version shims: JAX's ``set_mesh``, ``get_abstract_mesh`` and
``shard_map`` paper over moving JAX entry points. torch has one API for
each, so :func:`set_mesh` and :func:`get_abstract_mesh` here are a plain
ambient-mesh context (read by context-parallel decode), and ``shard_map``
has no counterpart: the port's per-shard code runs on
``DTensor.to_local()`` slices with explicit functional collectives
(``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Dict, Optional, Tuple

import torch

_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_abstract_mesh():
    """The innermost ambient mesh (:func:`set_mesh`), or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _resolve_type(device_type: Optional[str]) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch builds meshes on the card by "
                "default; pass device_type='cpu' for gloo ranks")
        return "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    return device_type


def _ensure_group(device_type: str, world: int) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a mesh of {world} devices in a process group "
                             f"of {dist.get_world_size()}")
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        if int(env["WORLD_SIZE"]) != world:
            raise ValueError(f"a mesh of {world} devices with WORLD_SIZE="
                             f"{env['WORLD_SIZE']}")
        if device_type == "cuda":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", env["RANK"])))
        dist.init_process_group(backend, init_method="env://")
        return
    if world != 1:
        raise ValueError(f"a mesh of {world} devices needs {world} ranks: "
                         "start them with RANK, WORLD_SIZE, MASTER_ADDR and "
                         "MASTER_PORT set (torchrun)")
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` with axis names ``axes`` (tests, elastic
    rescale, the launcher), on the card unless ``device_type="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _resolve_type(device_type)
    _ensure_group(device_type, math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh on the fake backend (rank 0 of 256 or 512):
    16×16 ``(data, model)``, or 2×16×16 ``(pod, data, model)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if dist.is_initialized():
        if (dist.get_backend() != "fake"
                or dist.get_world_size() != world):
            raise ValueError(
                f"the production mesh needs a fake group of {world} ranks; "
                f"this process runs {dist.get_backend()} with "
                f"{dist.get_world_size()}")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def shutdown() -> None:
    """Destroy this process's group (a no-op when none is started)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
