"""Public wrappers around the dataflow kernels — the port of
``repro.kernels.ops``.

Handles the device (the card unless the caller passes ``device="cpu"``),
padding to block multiples exactly as the JAX package pads (dense zero-pad;
ELL fiber pad with PAD_ID sentinels; minor-size pad is metadata only;
power-of-two capacity buckets), so launch shapes equal the JAX side's, the
class-indexed ``DISPATCH`` the executor uses, and ``op_cost``, the
modelled cost of one dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.costmodel import SW_KIND, sw_kernel_cost
from repro_torch.formats.ell import (
    PAD_ID,
    EllMatrix,
    bucket_capacity,
    pad_capacity,
)
from repro_torch.formats.taxonomy import DataflowClass
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import spgemm_gustavson as _gust
from repro_torch.kernels import spgemm_inner as _inner
from repro_torch.kernels import spgemm_outer as _outer
from repro_torch.kernels import spmm as _spmm


def resolve_device(device=None) -> torch.device:
    """``None`` means the card, and raises when there is none; the CPU runs
    only when asked for by name (the kernels' plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def _rup(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _auto_block(dim: int, requested: Optional[int]) -> int:
    """The JAX package's default block when the caller picks none: 256 when
    the dimension supports it, else 128."""
    if requested is not None:
        return requested
    return 256 if dim >= 256 and dim % 256 == 0 else 128


def _pad_dense(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    """Zero-pad both dims up to multiples; the result is contiguous (the
    kernels take row-major operands)."""
    p0 = _rup(x.shape[0], mult0) - x.shape[0]
    p1 = _rup(x.shape[1], mult1) - x.shape[1]
    if p0 or p1:
        x = torch.nn.functional.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def _pad_ell(e: EllMatrix, fiber_mult: int, minor_mult: int) -> EllMatrix:
    """Pad the fiber count with empty fibers, grow the logical minor size
    (metadata only), and bucket the capacity to a power of two. Never
    re-compresses and never shrinks the capacity, so every nonzero the ELL
    arrived with is kept."""
    nf = e.n_fibers
    pf = _rup(nf, fiber_mult) - nf
    vals, ids, lens = e.vals, e.ids, e.lens
    if pf:
        vals = torch.nn.functional.pad(vals, (0, 0, 0, pf))
        ids = torch.nn.functional.pad(ids, (0, 0, 0, pf), value=PAD_ID)
        lens = torch.nn.functional.pad(lens, (0, pf))
    minor = _rup(e.minor_size, minor_mult)
    shape = (nf + pf, minor) if e.major_axis == 0 else (minor, nf + pf)
    padded = EllMatrix(vals=vals, ids=ids, lens=lens, shape=shape,
                       major_axis=e.major_axis)
    return pad_capacity(padded, bucket_capacity(e.cap, max_cap=minor))


# --------------------------------------------------------- launch operands
def gemm_operands(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                  bn: int = 128, bk: int = 128):
    """The zero-padded operands :func:`gemm` hands its kernel: ``(ap,
    bp)``, ``a`` to ``(bm, bk)`` and ``b`` to ``(bk, bn)`` multiples."""
    return _pad_dense(a, bm, bk), _pad_dense(b, bk, bn)


def spmm_operands(a: torch.Tensor, b: EllMatrix, *, bm: Optional[int] = None,
                  bn: Optional[int] = None):
    """The padded operands and fiber block :func:`spmm` hands its kernel:
    ``(ap, bp, bn)``."""
    bm, bn = _auto_block(a.shape[0], bm), _auto_block(b.shape[1], bn)
    return _pad_dense(a, bm, 1), _pad_ell(b, bn, 1), bn


def spmm_mirror_operands(a: EllMatrix, b: torch.Tensor, *,
                         bm: Optional[int] = None, bn: Optional[int] = None):
    """:func:`spmm_operands` of ``spmm(bᵀ, aᵀ)``: ``aᵀ`` is the same fibers
    read as the transposed matrix, ``bᵀ`` is copied to a contiguous
    row-major operand."""
    at = dataclasses.replace(a, shape=(a.shape[1], a.shape[0]),
                             major_axis=1 - a.major_axis)
    return spmm_operands(b.T, at, bm=bm, bn=bn)


def spgemm_outer_operands(a: EllMatrix, b: EllMatrix, *,
                          bm: Optional[int] = None, bn: Optional[int] = None,
                          bk: int = 128):
    """The padded operands and windows :func:`spgemm_outer` hands its
    kernel: ``(ap, bp, bm, bn)``."""
    bm, bn = _auto_block(a.shape[0], bm), _auto_block(b.shape[1], bn)
    return _pad_ell(a, bk, bm), _pad_ell(b, bk, bn), bm, bn


def spgemm_inner_operands(a: EllMatrix, b: EllMatrix, *,
                          bm: Optional[int] = None, bn: Optional[int] = None,
                          bk: int = 128):
    """The padded operands and fiber blocks :func:`spgemm_inner` hands its
    kernel: ``(ap, bp, bm, bn)``. The blocks default to 128, not
    :func:`_auto_block`'s 256: the sparse body's trip count is the largest
    fiber length of a block, and smaller blocks keep it tight."""
    bm, bn = bm or 128, bn or 128
    return _pad_ell(a, bm, bk), _pad_ell(b, bn, bk), bm, bn


def spgemm_gustavson_operands(a: EllMatrix, b: EllMatrix, *,
                              bm: Optional[int] = None,
                              bn: Optional[int] = None, bk: int = 128):
    """The padded operands and blocks :func:`spgemm_gustavson` hands its
    kernel: ``(ap, bp, bm, bn)``, A's K fibers to ``bk`` and its minor M to
    ``bm`` multiples, B's N fibers to ``bn`` and its minor K to ``bk``."""
    bm, bn = _auto_block(a.shape[0], bm), _auto_block(b.shape[1], bn)
    return _pad_ell(a, bk, bm), _pad_ell(b, bn, bk), bm, bn


# --------------------------------------------------------------------- ops
def gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
         bk: int = 128, device=None):
    """(U_M U_K, U_K U_N) TPU-like dense GEMM."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp = gemm_operands(a, b, bm=bm, bn=bn, bk=bk)
    return _gemm.gemm(ap, bp)[:m, :n]


def spmm(a: torch.Tensor, b: EllMatrix, *, bm: Optional[int] = None,
         bn: Optional[int] = None, method: str = "auto", device=None):
    """(U_M U_K, U_N C_K) EIE-like SpMM: dense A × compressed B."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp, bn = spmm_operands(a, b, bm=bm, bn=bn)
    return _spmm.spmm(ap, bp, bn=bn, method=method)[:m, :n]


def spmm_mirror(a: EllMatrix, b: torch.Tensor, *, bm: Optional[int] = None,
                bn: Optional[int] = None, method: str = "auto", device=None):
    """(U_M C_K, U_K U_N) mirrored EIE-like SpMM == spmm(Bᵀ, Aᵀ)ᵀ: the
    same kernel by transposition, with the parallelism bound moved from N
    to M (paper §III-A)."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp, bn = spmm_mirror_operands(a, b, bm=bm, bn=bn)
    return _spmm.spmm(ap, bp, bn=bn, method=method)[:n, :m].T


def spgemm_outer(a: EllMatrix, b: EllMatrix, *, bm: Optional[int] = None,
                 bn: Optional[int] = None, bk: int = 128,
                 method: str = "auto", device=None):
    """(U_K C_M, U_K C_N) OuterSPACE-like outer-product SpGEMM."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp, bm, bn = spgemm_outer_operands(a, b, bm=bm, bn=bn, bk=bk)
    return _outer.spgemm_outer(ap, bp, bm=bm, bn=bn, method=method)[:m, :n]


def spgemm_inner(a: EllMatrix, b: EllMatrix, *, bm: Optional[int] = None,
                 bn: Optional[int] = None, bk: int = 128,
                 method: str = "auto", device=None):
    """(U_M C_K, U_N C_K) ExTensor-like inner-product SpGEMM."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp, bm, bn = spgemm_inner_operands(a, b, bm=bm, bn=bn, bk=bk)
    return _inner.spgemm_inner(ap, bp, bm=bm, bn=bn, bk=bk,
                               method=method)[:m, :n]


def spgemm_gustavson(a: EllMatrix, b: EllMatrix, *, bm: Optional[int] = None,
                     bn: Optional[int] = None, bk: int = 128,
                     method: str = "auto", device=None):
    """(U_K C_M, U_N C_K) MatRaptor-like Gustavson SpGEMM."""
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    m, n = a.shape[0], b.shape[1]
    ap, bp, bm, bn = spgemm_gustavson_operands(a, b, bm=bm, bn=bn, bk=bk)
    return _gust.spgemm_gustavson(ap, bp, bm=bm, bn=bn, bk=bk,
                                  method=method)[:m, :n]


#: Class-indexed dispatch used by the executor (core/hetero_matmul).
DISPATCH = {
    DataflowClass.GEMM: gemm,
    DataflowClass.SPMM: spmm,
    DataflowClass.SPGEMM_INNER: spgemm_inner,
    DataflowClass.SPGEMM_OUTER: spgemm_outer,
    DataflowClass.SPGEMM_GUSTAVSON: spgemm_gustavson,
}


def dispatch(cls: DataflowClass, a, b, **kw):
    """Run one matmul on the sub-accelerator class ``cls`` (operands must
    already be in REQUIRED_FORMATS[cls])."""
    return DISPATCH[cls](a, b, **kw)


def op_cost(cls: DataflowClass, a, b, *, bm: Optional[int] = None,
            bn: Optional[int] = None, method: str = "auto",
            mirror: bool = False):
    """Modelled cost of ``dispatch(cls, a, b)`` — the achieved-intensity
    hook. Returns a :class:`repro_torch.core.costmodel.SwKernelCost` whose
    ``flops``/``bytes`` give the modelled roofline intensity and whose
    ``mac_eq`` is the JAX package's time proxy (the same numbers both
    packages report).

    Reads the true nonzero counts (``EllMatrix.nnz``) on the host, a sync
    per compressed operand, so call it beside the hot path, never in it.
    """
    if mirror:   # spmm_mirror(a, b) == spmm(bᵀ, aᵀ)ᵀ: cost the transpose
        at = dataclasses.replace(a, shape=(a.shape[1], a.shape[0]),
                                 major_axis=1 - a.major_axis)
        return op_cost(cls, b.T, at, bm=bn, bn=bm, method=method)

    m = a.shape[0]
    k = a.shape[1]
    n = b.shape[1]
    kw = dict(bm=_auto_block(m, bm), bn=_auto_block(n, bn), method=method)
    if isinstance(a, EllMatrix):
        kw["nnz_a"] = float(a.nnz())
        kw["cap_a"] = a.cap
    if isinstance(b, EllMatrix):
        kw["nnz_b"] = float(b.nnz())
        kw["cap_b"] = b.cap
    return sw_kernel_cost(SW_KIND[cls], m, k, n, **kw)
