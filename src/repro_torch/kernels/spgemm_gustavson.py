"""MatRaptor-like Gustavson (column-wise product) SpGEMM (U_K C_M, U_N C_K)
on Hopper — the port of ``repro.kernels.spgemm_gustavson``: ``a`` held as
K column fibers (ids -> M) times ``b`` held as N column fibers (ids -> K)
gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spgemm_gustavson.cu``:

``method="sparse"`` — scatters A's fibers once into the rows of a dense
``(K, M)`` f32 table in device memory (a kernel of its own: the TPU's
build-at-the-first-N-step trick races on CUDA), then B's fibers drive a
gather-contract over their live capacity chunks (the kernel the inner
product's sparse body uses, storing its tile transposed); M windows A
proves empty write zeros.

``method="reference"`` — per ``(M, N)`` tile and K step of ``bk``, skips
unless both operands have an entry there (``tile_occupancy``), expands A's
``bk`` fibers over the tile's M range and B's fibers over the step into
shared memory and applies a rank-``bk`` update.

``"auto"`` keeps the TPU's rule: sparse when ``4·cap_b <= K``.

Both bodies compute the same function; :func:`spgemm_gustavson_plain` is
its plain PyTorch version, which a wrapper runs for tensors on the CPU and
only then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.formats.ell import (
    EllMatrix,
    block_chunk_counts,
    block_window_nnz,
    ell_to_dense,
    pad_capacity,
    tile_occupancy,
)
from repro_torch.kernels import _build
from repro_torch.kernels.spgemm_inner import _ordered, _step_offsets
from repro_torch.kernels.spmm import fit_block

#: Capacity-chunk width of the gather contraction over B's column fibers.
GUSTAVSON_FIBER_CHUNK = 16

#: The reference kernel's largest K step, and its output tile's M extent
#: (A's occupancy and slot ranges are per M tile of this width).
GUSTAVSON_REFERENCE_BK_MAX = 128
GUSTAVSON_REFERENCE_TILE_M = 128

#: Kernel launches per body since the counts were last reset.
launches = {"gustavson_sparse": 0, "gustavson_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gustavson_sparse_launch": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _I,
                                _P, _P, _I, _I, _I, _I, _P],
    "gustavson_reference_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                                   _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
}


def resolve_method(method: str, k: int, cap_b: int) -> str:
    """The body ``method`` selects: ``"auto"`` is sparse while the gather
    volume (∝ ``cap_b``) undercuts the dense-K expansion it replaces."""
    if method == "auto":
        return "sparse" if 4 * cap_b <= k else "reference"
    if method in ("sparse", "reference"):
        return method
    raise ValueError(f"unknown spgemm_gustavson method: {method!r}")


def spgemm_gustavson(a: EllMatrix, b: EllMatrix, *, bm: int = 128,
                     bn: int = 128, bk: int = 128,
                     method: str = "auto") -> torch.Tensor:
    """A (K column fibers, ids->M) × B (N column fibers, ids->K) -> ``(M,
    N)`` in ``result_type(a.vals, b.vals)``. ``bm`` is the M window of the
    sparse body's empty-window test, ``bn`` the fiber block of B's chunk
    counts and occupancy, ``bk`` the reference body's K step; all shrink
    to divide ragged shapes."""
    assert a.major_axis == 1 and b.major_axis == 1
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bm, bn = fit_block(m, bm), fit_block(n, bn)
    dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    a = dataclasses.replace(a, vals=a.vals.to(dtype))
    b = dataclasses.replace(b, vals=b.vals.to(dtype))
    if resolve_method(method, k, b.cap) == "sparse":
        return gustavson_sparse(a, b, bm=bm, bn=bn,
                                fc=min(GUSTAVSON_FIBER_CHUNK, b.cap))
    return gustavson_reference(a, b, bn=bn, bk=fit_block(k, bk))


def spgemm_gustavson_plain(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """Plain PyTorch version of both bodies: both operands densified
    (``ell_to_dense``) and multiplied in f32. B is densified too rather
    than gathered slot by slot: a gather of ``(N, cap, M)`` table rows
    costs ``N·cap·M`` loads, about 2.6 TB at m3plates, where B is dense."""
    out_dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    return (ell_to_dense(a).float() @ ell_to_dense(b).float()).to(out_dtype)


def _check(what: str, a: EllMatrix, b: EllMatrix) -> int:
    _build.require_cuda_operands(what, a.vals, a.ids, a.lens, b.vals, b.ids,
                                 b.lens)
    if any(t.dtype != torch.int32 for t in (a.ids, a.lens, b.ids, b.lens)):
        raise ValueError(f"{what}: ids and lens must be int32")
    if (a.major_axis, b.major_axis) != (1, 1) or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: shapes {a.shape} x {b.shape} (major axes "
                         f"{a.major_axis}, {b.major_axis})")
    return _build.dtype_code(what, a.vals.dtype, b.vals.dtype)


def gustavson_sparse(a: EllMatrix, b: EllMatrix, *, bm: int, bn: int,
                     fc: int) -> torch.Tensor:
    """The sparse body: A's row scatter + B-driven gather-contract on the
    card, or :func:`spgemm_gustavson_plain` for CPU tensors."""
    if a.vals.device.type == "cpu":
        return spgemm_gustavson_plain(a, b)
    code = _check("gustavson_sparse", a, b)
    m, k = a.shape
    n = b.shape[1]
    if m % bm or n % bn:
        raise ValueError(f"gustavson_sparse: {m} x {n} not multiples of "
                         f"bm={bm}, bn={bn}")
    chunks = -(-b.cap // fc)
    if chunks * fc != b.cap:
        b = pad_capacity(b, chunks * fc)
    awin = block_window_nnz(a, bm)                 # A nnz per M window
    bcnt = block_chunk_counts(b, bn, fc)           # live B chunks per N block
    dev = a.vals.device
    table = torch.zeros((k, m), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_gustavson", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.gustavson_sparse_launch(
            P(a.vals), P(a.ids), a.cap, P(awin), bm, P(b.vals), P(b.ids),
            b.cap, P(bcnt), bn, fc, P(table), P(out), m, k, n, code,
            _build.stream(dev)), "gustavson_sparse")
    launches["gustavson_sparse"] += 1
    return out


def gustavson_reference(a: EllMatrix, b: EllMatrix, *, bn: int,
                        bk: int) -> torch.Tensor:
    """The reference body: occupancy-skipped per-tile expansion + rank-bk
    updates on the card, or :func:`spgemm_gustavson_plain` for CPU
    tensors.

    The kernel reads A's entries in an M tile, and B's in a K step, of an
    ordered fiber (see ``spgemm_inner._ordered``) as one run of slots, and
    scans every slot of a fiber out of order. ``bk`` must divide K and be
    at most :data:`GUSTAVSON_REFERENCE_BK_MAX`.
    """
    if a.vals.device.type == "cpu":
        return spgemm_gustavson_plain(a, b)
    code = _check("gustavson_reference", a, b)
    m, k = a.shape
    n = b.shape[1]
    if n % bn or k % bk or bk > GUSTAVSON_REFERENCE_BK_MAX:
        raise ValueError(f"gustavson_reference: {m}x{k}x{n} with bn={bn}, "
                         f"bk={bk} (bk <= {GUSTAVSON_REFERENCE_BK_MAX} "
                         "dividing K)")
    k_steps = k // bk
    occ_a = tile_occupancy(a, GUSTAVSON_REFERENCE_TILE_M)   # (K, M tiles)
    occ_b = tile_occupancy(b, bk)                           # (N, K steps)
    a_occ = occ_a.reshape(k_steps, bk, -1).sum(1, dtype=torch.int32)
    b_occ = occ_b.reshape(n // bn, bn, k_steps).sum(1, dtype=torch.int32)
    a_off, b_off = _step_offsets(occ_a), _step_offsets(occ_b)
    a_ord, b_ord = _ordered(a), _ordered(b)
    dev = a.vals.device
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_gustavson", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.gustavson_reference_launch(
            P(a.vals), P(a.ids), P(a_off), P(a_ord), a.cap, P(b.vals),
            P(b.ids), P(b_off), P(b_ord), b.cap, P(a_occ), P(b_occ), bn,
            P(out), m, k, n, bk, code, _build.stream(dev)),
            "gustavson_reference")
    launches["gustavson_reference"] += 1
    return out
