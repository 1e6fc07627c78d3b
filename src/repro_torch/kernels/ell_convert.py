"""Dense to ELL on Hopper: :func:`dense_to_ell_cuda` compresses a 2-D
float32 or bfloat16 CUDA tensor, of any two strides, into the same
:class:`~repro_torch.formats.ell.EllMatrix` as the plain version
(:func:`repro_torch.formats.ell.dense_to_ell_plain`), bit for bit, with
the kernels of ``csrc/ell_convert.cu``: each fiber's nonzeros compacted in
one pass over the slice, no sort, no order array, no mask and no copy of
the slice. ``formats.ell.dense_to_ell`` calls it for every CUDA tensor.

It replaces no TPU kernel (the JAX package's conversion is a stable
``jnp.argsort``); it is bound by its bytes, the slice read once and the
ELL written once. :func:`ell_convert_plan` picks the body from the strides
the slice has: row fibers (contiguous along the fiber, or neither stride
1) a warp each; column fibers (the fiber stride 1) 32 to a block, walked
down the rows. Each fiber is walked whole, in one launch.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.formats.ell import EllMatrix, require_fits
from repro_torch.kernels import _build

#: Calls of :func:`dense_to_ell_cuda` that launched the kernels since the
#: count was last reset.
launches = {"dense_to_ell": 0}

#: The bodies (``rt::kRows``, ``rt::kCols``).
ROWS, COLS = 0, 1
#: Warps a block, packs a lane keeps in flight in the row body, and rows a
#: step of the column body (``EC_WARPS``, ``EC_UNROLL``, ``EC_ROWS``).
EC_WARPS = 8
EC_UNROLL = 4
EC_ROWS = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ell_convert_launch": [_P, _L, _L, _L, _L, _I, _P, _P, _P, _P, _I, _I,
                           _I, _P],
}


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """How one conversion launches: the body (:data:`ROWS` or
    :data:`COLS`) and the row body's load in bytes a lane a step (a pack
    of elements when the fibers are contiguous and aligned to it, else one
    element)."""

    layout: int
    vec_bytes: int


def ell_convert_plan(n_fibers: int, length: int, s_fiber: int,
                     s_minor: int, elem: int, ptr: int) -> EllPlan:
    """The plan for ``n_fibers`` fibers of ``length`` elements of ``elem``
    bytes at element strides ``s_fiber`` and ``s_minor`` from address
    ``ptr``. A size-1 axis's stride does not matter. The column body takes
    fibers that lie side by side (``s_fiber == 1``, ``s_minor`` not), the
    row body all others."""
    if length <= 1:
        s_minor = 1
    if s_minor != 1 and s_fiber == 1 and n_fibers > 1:
        return EllPlan(COLS, elem)
    if s_minor == 1:
        for nbytes in (16, 8, 4, 2):
            if (nbytes % elem == 0 and ptr % nbytes == 0
                    and length * elem % nbytes == 0
                    and (n_fibers <= 1 or s_fiber * elem % nbytes == 0)):
                return EllPlan(ROWS, nbytes)
    return EllPlan(ROWS, elem)


def dense_to_ell_cuda(dense: torch.Tensor, major_axis: int, cap: int,
                      strict: bool = False) -> EllMatrix:
    """:func:`repro_torch.formats.ell.dense_to_ell` of a CUDA tensor on
    the card, on PyTorch's current stream; raises on a tensor the kernels
    do not take. ``strict`` reads the fullest fiber's count on the host
    (the kernels take it with one atomic a fiber)."""
    code = _build.dtype_code("dense_to_ell", dense.dtype)
    if dense.device.type != "cuda":
        raise ValueError(f"dense_to_ell_cuda: a CUDA tensor, got "
                         f"{dense.device}")
    work = dense if major_axis == 0 else dense.T
    n, length = work.shape
    if length > 2**31 - 1 or cap > 2**31 - 1:
        raise ValueError(f"dense_to_ell_cuda: fibers of {length} elements "
                         f"at cap={cap} (int32 ids and slots)")
    dev = dense.device
    vals = torch.empty((n, cap), dtype=dense.dtype, device=dev)
    ids = torch.empty((n, cap), dtype=torch.int32, device=dev)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    worst = torch.zeros(1, dtype=torch.int32, device=dev) if strict else None
    if n:
        plan = ell_convert_plan(n, length, *work.stride(),
                                work.element_size(), work.data_ptr())
        lib = _build.load("ell_convert", _SIGNATURES)
        P = _build.ptr
        with torch.cuda.device(dev):
            _build.check(lib.ell_convert_launch(
                P(work), n, length, *work.stride(), cap, P(vals), P(ids),
                P(lens), None if worst is None else P(worst),
                plan.layout, plan.vec_bytes, code,
                _build.stream(dev)), "dense_to_ell")
        launches["dense_to_ell"] += 1
    if strict:
        require_fits(int(worst), cap, major_axis, dense.shape)
    return EllMatrix(vals=vals, ids=ids, lens=lens,
                     shape=tuple(dense.shape), major_axis=major_axis)
