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

``method="reference"`` — never builds a table: per 128 x 128 output tile a
walk over the 32-wide K chunks some B fiber of the N tile holds
(:func:`live_chunks`), A's chunk copied into shared memory with
``cp.async`` and B's fibers expanded over it, each chunk a rank-32 update
(the chunked rank-update kernel of ``csrc/chunk_update.cuh``, shared with
the inner and Gustavson reference bodies).

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
from repro_torch.kernels.spgemm_outer import tile_live_lists

#: Capacity-chunk width over which the scatter walks live slots.
SPMM_FIBER_CHUNK = 64

#: The reference kernel's output tile (``CU_N`` in ``csrc/chunk_update.cuh``)
#: and the K chunk of its rank updates (``CU_KC``): its live-chunk lists are
#: per N tile of this width.
REFERENCE_TILE = 128
REFERENCE_CHUNK = 32

#: Kernel launches per body since the counts were last reset.
launches = {"spmm_sparse": 0, "spmm_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmm_sparse_launch": [_P] * 6 + [_I] * 7 + [_P],
    "spmm_reference_launch": [_P] * 6 + [_I] + [_P] + [_I] * 5 + [_P],
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
    c]] · vals[n, c]`` over live slots (ids in ``[0, K)``; any other id is
    dropped, as the TPU's expansion drops it), accumulated in f32, in
    column chunks that bound the gathered ``(M, chunk, cap)`` block."""
    m, k = a.shape
    n, cap = b.n_fibers, b.cap
    out_dtype = torch.promote_types(a.dtype, b.vals.dtype)
    af = a.float()
    live = (b.ids >= 0) & (b.ids < k)
    safe = torch.where(live, b.ids, 0).long()
    vals = torch.where(live, b.vals.float(), 0.0)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    step = max(1, (1 << 26) // max(m * cap, 1))
    for n0 in range(0, n, step):
        n1 = min(n, n0 + step)
        g = af[:, safe[n0:n1].reshape(-1)].reshape(m, n1 - n0, cap)
        out[:, n0:n1] = (g * vals[n0:n1][None]).sum(dim=-1).to(out_dtype)
    return out


def live_chunks(b: EllMatrix) -> tuple:
    """The reference body's walk: per N tile of :data:`REFERENCE_TILE`
    fibers, the ascending :data:`REFERENCE_CHUNK`-wide K chunks some fiber
    of the tile holds, ``(chunks (T, C + 1), counts (T,))`` int32 with ``C
    = ceil(K / REFERENCE_CHUNK)`` (see ``spgemm_outer.tile_live_lists``).
    The plain version of the kernel's own walk: the launch's fiber scan
    flags these chunks on the card, and the kernel skips the others."""
    return tile_live_lists(b, REFERENCE_TILE, REFERENCE_CHUNK)


def row_granule(a: torch.Tensor) -> int:
    """Elements per ``cp.async`` copy of ``a``'s rows in the reference
    kernel: the widest of 16, 8 and 4 bytes that every row start is
    aligned to; 1 for a bf16 row of odd length, which the kernel then
    copies element by element with plain loads."""
    size = a.element_size()
    row = a.shape[1] * size
    for nbytes in (16, 8, 4):
        if nbytes >= size and row % nbytes == 0 and a.data_ptr() % nbytes == 0:
            return nbytes // size
    return 1


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
    """The reference body: live-chunk rank updates on the card
    (:func:`live_chunks`), or :func:`spmm_plain` for CPU tensors."""
    if a.device.type == "cpu":
        return spmm_plain(a, b)
    return _spmm_reference_launch(a, b)


def _spmm_reference_launch(a: torch.Tensor, b: EllMatrix) -> torch.Tensor:
    code = _check("spmm_reference", a, b)
    m, k = a.shape
    n, cap = b.n_fibers, b.cap
    if -(-m // REFERENCE_TILE) > 65535:
        raise ValueError(f"spmm_reference: M={m} gives more than 65535 M "
                         "tiles (the grid's y extent)")
    n_chunks = -(-k // REFERENCE_CHUNK)
    dev = a.device
    b_kind = torch.empty(n, dtype=torch.int32, device=dev)
    b_starts = torch.empty((n_chunks + 1, n), dtype=torch.int32, device=dev)
    b_live = torch.zeros((-(-n // REFERENCE_TILE), n_chunks),
                         dtype=torch.uint8, device=dev)
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.spmm_reference_launch(
            P(a), P(b.vals), P(b.ids), P(b_kind), P(b_starts), P(b_live),
            cap, P(out), m, k, n, row_granule(a), code, _build.stream(dev)),
            "spmm_reference")
    launches["spmm_reference"] += 1
    return out
