"""EIE-like SpMM (U_M U_K, U_N C_K) on Hopper — the port of
``repro.kernels.spmm``: dense ``a (M, K)`` times ``b`` held as N column
fibers (ids -> K) gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spmm.cu``:

``method="sparse"`` — scatters B's live fiber chunks once into a dense
``(K, N)`` f32 table in device memory (a kernel of its own: the TPU's
build-at-the-first-grid-step trick races on CUDA), then contracts ``A ·
table`` with a shared-memory tiled f32 kernel; fiber blocks with no live
chunk write zeros.

``method="reference"`` — never builds a table: each output column walks its
fiber's nonzeros and gathers the matching columns of A from a shared-memory
staging buffer.

``"auto"`` keeps the TPU's rule: sparse when ``2·cap <= K``.

Both bodies compute the same function; :func:`spmm_plain` is its plain
PyTorch version, which a wrapper runs for tensors on the CPU and only
then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.formats.ell import EllMatrix, block_chunk_counts
from repro_torch.kernels import _build

#: Capacity-chunk width over which the scatter walks live slots.
SPMM_FIBER_CHUNK = 64

#: Kernel launches per body since the counts were last reset.
launches = {"spmm_sparse": 0, "spmm_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmm_sparse_launch": [_P] * 6 + [_I] * 7 + [_P],
    "spmm_reference_launch": [_P] * 4 + [_I] * 5 + [_P],
}


def fit_block(dim: int, block: int) -> int:
    """Largest usable block size <= ``block`` that divides ``dim``:
    ``dim < block`` collapses to one block, a non-dividing ``dim`` falls
    back to ``gcd(dim, block)``."""
    assert dim >= 1, dim
    if dim <= block:
        return dim
    if dim % block == 0:
        return block
    return math.gcd(dim, block)


def resolve_method(method: str, k: int, cap: int) -> str:
    """The body ``method`` selects: ``"auto"`` is sparse unless the fibers
    are so dense (``cap > K/2``) that the scatter costs more than the
    expansion it replaces."""
    if method == "auto":
        return "sparse" if 2 * cap <= k else "reference"
    if method in ("sparse", "reference"):
        return method
    raise ValueError(f"unknown spmm method: {method!r}")


def spmm(a: torch.Tensor, b: EllMatrix, *, bn: int = 128,
         method: str = "auto") -> torch.Tensor:
    """Dense ``a (M, K)`` × compressed ``b`` (column fibers, ids->K) ->
    ``(M, N)`` in ``result_type(a, b.vals)``. Blocks auto-shrink to divide
    ragged shapes; ``bn`` is the fiber-block size of the sparse body's
    chunk counts (the CUDA tiles themselves are fixed)."""
    assert b.major_axis == 1, "spmm expects B in U_N C_K (column fibers)"
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bn = fit_block(n, bn)
    dtype = torch.promote_types(a.dtype, b.vals.dtype)
    a = a.to(dtype)
    b = dataclasses.replace(b, vals=b.vals.to(dtype))
    if resolve_method(method, k, b.cap) == "sparse":
        return spmm_sparse(a, b, bn=bn)
    return spmm_reference(a, b)


def spmm_plain(a: torch.Tensor, b: EllMatrix) -> torch.Tensor:
    """Plain PyTorch version of both bodies: ``out[:, n] = Σ_c a[:, ids[n,
    c]] · vals[n, c]`` over live slots, accumulated in f32, in column chunks
    that bound the gathered ``(M, chunk, cap)`` block."""
    m = a.shape[0]
    n, cap = b.n_fibers, b.cap
    out_dtype = torch.promote_types(a.dtype, b.vals.dtype)
    af = a.float()
    live = b.ids >= 0
    safe = torch.where(live, b.ids, 0).long()
    vals = torch.where(live, b.vals.float(), 0.0)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    step = max(1, (1 << 26) // max(m * cap, 1))
    for n0 in range(0, n, step):
        n1 = min(n, n0 + step)
        g = af[:, safe[n0:n1].reshape(-1)].reshape(m, n1 - n0, cap)
        out[:, n0:n1] = (g * vals[n0:n1][None]).sum(dim=-1).to(out_dtype)
    return out


def _check(what: str, a: torch.Tensor, b: EllMatrix) -> int:
    _build.require_cuda_operands(what, a, b.vals, b.ids, b.lens)
    if b.ids.dtype != torch.int32 or b.lens.dtype != torch.int32:
        raise ValueError(f"{what}: ids and lens must be int32")
    if a.ndim != 2 or a.shape[1] != b.shape[0] or b.major_axis != 1:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} x {b.shape} "
                         f"(major_axis {b.major_axis})")
    return _build.dtype_code(what, a.dtype, b.vals.dtype)


def spmm_sparse(a: torch.Tensor, b: EllMatrix, *, bn: int) -> torch.Tensor:
    """The sparse body: scatter table + tiled contraction on the card, or
    :func:`spmm_plain` for CPU tensors."""
    if a.device.type == "cpu":
        return spmm_plain(a, b)
    code = _check("spmm_sparse", a, b)
    m, k = a.shape
    n, cap = b.n_fibers, b.cap
    if n % bn:
        raise ValueError(f"spmm_sparse: {n} fibers not a multiple of bn={bn}")
    fc = min(SPMM_FIBER_CHUNK, cap)
    counts = block_chunk_counts(b, bn, fc)
    table = torch.zeros((k, n), dtype=torch.float32, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.load("spmm", _SIGNATURES)
    with torch.cuda.device(a.device):
        _build.check(lib.spmm_sparse_launch(
            _build.ptr(a), _build.ptr(b.vals), _build.ptr(b.ids),
            _build.ptr(counts), _build.ptr(table), _build.ptr(out),
            m, k, n, cap, bn, fc, code, _build.stream(a.device)),
            "spmm_sparse")
    launches["spmm_sparse"] += 1
    return out


def spmm_reference(a: torch.Tensor, b: EllMatrix) -> torch.Tensor:
    """The reference body: fiber walk over shared-memory staged A on the
    card, or :func:`spmm_plain` for CPU tensors."""
    if a.device.type == "cpu":
        return spmm_plain(a, b)
    code = _check("spmm_reference", a, b)
    m, k = a.shape
    n, cap = b.n_fibers, b.cap
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.load("spmm", _SIGNATURES)
    with torch.cuda.device(a.device):
        _build.check(lib.spmm_reference_launch(
            _build.ptr(a), _build.ptr(b.vals), _build.ptr(b.ids),
            _build.ptr(out), m, k, n, cap, code, _build.stream(a.device)),
            "spmm_reference")
    launches["spmm_reference"] += 1
    return out
