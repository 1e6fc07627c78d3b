"""OuterSPACE-like outer-product SpGEMM (U_K C_M, U_K C_N) on Hopper — the
port of ``repro.kernels.spgemm_outer``: ``a`` held as K fibers (ids -> M)
times ``b`` held as K fibers (ids -> N) gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spgemm_outer.cu``:

``method="sparse"`` — scatters both operands once into dense ``(M, K)`` and
``(N, K)`` f32 tables in device memory (a kernel of its own: the TPU's
build-at-step-(0, 0) trick races on CUDA), then contracts table rows with a
shared-memory tiled f32 kernel; tiles whose M or N window holds no nonzero
(``block_window_nnz``) write zeros.

``method="reference"`` — per output tile, expands each block of K fibers
against the tile's M and N windows in shared memory and applies a rank
update to register accumulators.

``"auto"`` keeps the TPU's rule: sparse while both tables fit
:data:`OUTER_TABLE_BYTES_MAX`.

Both bodies compute the same function; :func:`spgemm_outer_plain` is its
plain PyTorch version, which a wrapper runs for tensors on the CPU and only
then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.formats.ell import EllMatrix, block_window_nnz
from repro_torch.kernels import _build
from repro_torch.kernels.spmm import fit_block

#: Budget of the sparse body's two f32 tables, ``4·K·(M+N)`` bytes — the
#: TPU's VMEM budget, kept so "auto" picks the same body on both packages.
OUTER_TABLE_BYTES_MAX = 8 << 20

#: Kernel launches per body since the counts were last reset.
launches = {"outer_sparse": 0, "outer_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "outer_sparse_launch": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                            _P, _P, _P, _I, _I, _I, _I, _P],
    "outer_reference_launch": [_P, _P, _I, _P, _P, _I, _P,
                               _I, _I, _I, _I, _P],
}


def resolve_method(method: str, m: int, k: int, n: int) -> str:
    """The body ``method`` selects: ``"auto"`` is sparse while both
    resident tables fit :data:`OUTER_TABLE_BYTES_MAX`."""
    if method == "auto":
        fits = 4 * k * (m + n) <= OUTER_TABLE_BYTES_MAX
        return "sparse" if fits else "reference"
    if method in ("sparse", "reference"):
        return method
    raise ValueError(f"unknown spgemm_outer method: {method!r}")


def spgemm_outer(a: EllMatrix, b: EllMatrix, *, bm: int = 128,
                 bn: int = 128, method: str = "auto") -> torch.Tensor:
    """A (K column-fibers, ids->M) × B (K row-fibers, ids->N) -> ``(M, N)``
    in ``result_type(a.vals, b.vals)``. ``bm``/``bn`` are the window sizes
    of the sparse body's tile skipping, shrunk to divide ragged shapes."""
    assert a.major_axis == 1 and b.major_axis == 0
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bm, bn = fit_block(m, bm), fit_block(n, bn)
    dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    a = dataclasses.replace(a, vals=a.vals.to(dtype))
    b = dataclasses.replace(b, vals=b.vals.to(dtype))
    if resolve_method(method, m, k, n) == "sparse":
        return outer_sparse(a, b, bm=bm, bn=bn)
    return outer_reference(a, b)


def spgemm_outer_plain(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """Plain PyTorch version of both bodies, OuterSPACE's loop order: for
    every live entry ``(k, m, v)`` of A, add ``v · B[k, :]`` to row ``m``
    (B densified per fiber), accumulated in f32, in entry chunks that bound
    the ``(chunk, N)`` block."""
    m, n = a.shape[0], b.shape[1]
    out_dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    dev = a.vals.device
    eb = torch.zeros((b.n_fibers, n + 1), dtype=torch.float32, device=dev)
    eb.scatter_add_(1, torch.where(b.ids >= 0, b.ids, n).long(),
                    b.vals.float())
    eb = eb[:, :n]
    live = a.ids >= 0
    k_of, slot = torch.nonzero(live, as_tuple=True)
    rows = a.ids[k_of, slot].long()
    vals = a.vals[k_of, slot].float()
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    step = max(1, (1 << 26) // max(n, 1))
    for e0 in range(0, rows.numel(), step):
        e1 = e0 + step
        out.index_add_(0, rows[e0:e1], vals[e0:e1, None] * eb[k_of[e0:e1]])
    return out.to(out_dtype)


def _check(what: str, a: EllMatrix, b: EllMatrix) -> int:
    _build.require_cuda_operands(what, a.vals, a.ids, a.lens, b.vals, b.ids,
                                 b.lens)
    if any(t.dtype != torch.int32 for t in (a.ids, a.lens, b.ids, b.lens)):
        raise ValueError(f"{what}: ids and lens must be int32")
    if (a.major_axis, b.major_axis) != (1, 0) or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: shapes {a.shape} x {b.shape} (major axes "
                         f"{a.major_axis}, {b.major_axis})")
    return _build.dtype_code(what, a.vals.dtype, b.vals.dtype)


def outer_sparse(a: EllMatrix, b: EllMatrix, *, bm: int,
                 bn: int) -> torch.Tensor:
    """The sparse body: two scatter tables + tiled contraction on the card,
    or :func:`spgemm_outer_plain` for CPU tensors."""
    if a.vals.device.type == "cpu":
        return spgemm_outer_plain(a, b)
    code = _check("outer_sparse", a, b)
    (m, k), n = a.shape, b.shape[1]
    dev = a.vals.device
    awin = block_window_nnz(a, bm)
    bwin = block_window_nnz(b, bn)
    ta = torch.zeros((m, k), dtype=torch.float32, device=dev)
    tb = torch.zeros((n, k), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_outer", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.outer_sparse_launch(
            P(a.vals), P(a.ids), a.cap, P(b.vals), P(b.ids), b.cap,
            P(awin), bm, P(bwin), bn, P(ta), P(tb), P(out), m, k, n, code,
            _build.stream(dev)), "outer_sparse")
    launches["outer_sparse"] += 1
    return out


def outer_reference(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """The reference body: per-tile windowed expansion + rank updates on
    the card, or :func:`spgemm_outer_plain` for CPU tensors."""
    if a.vals.device.type == "cpu":
        return spgemm_outer_plain(a, b)
    code = _check("outer_reference", a, b)
    (m, k), n = a.shape, b.shape[1]
    dev = a.vals.device
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_outer", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.outer_reference_launch(
            P(a.vals), P(a.ids), a.cap, P(b.vals), P(b.ids), b.cap, P(out),
            m, k, n, code, _build.stream(dev)), "outer_reference")
    launches["outer_reference"] += 1
    return out
