"""MatRaptor-like Gustavson (column-wise product) SpGEMM (U_K C_M, U_N C_K)
on Hopper — the port of ``repro.kernels.spgemm_gustavson``: ``a`` held as
K column fibers (ids -> M) times ``b`` held as N column fibers (ids -> K)
gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spgemm_gustavson.cu``:

``method="sparse"`` (replaces ``_gustavson_sparse_kernel``) — builds no
table: the outer product's row merge (``csrc/row_merge.cuh``) on ``Oᵀ =
Bᵀ·Aᵀ``. A warp owns one of B's fibers, a row of ``Oᵀ``, and an M chunk of
:data:`GUSTAVSON_SPARSE_COLS` f32 accumulators in shared memory; it walks
the fiber's slots in place, in slot order, and for each entry ``(k, b)``
adds ``b·A[:, k]`` over A's fiber k's run in the chunk (a binary search
for an ordered fiber, none for a dense one, every id tested for one out
of order). The work goes with the ``(a, b)`` pairs plus one write of the
output; no float atomics, and two runs give the same bits. The kernel
stores ``Oᵀ`` and the wrapper returns its ``(M, N)`` transposed view
(:func:`gustavson_sparse_grid` gives the launch's blocks).

``method="reference"`` — per 128 x 128 output tile, a walk over only the K
fibers of A that hold an entry in the M tile (``spgemm_outer.live_k_lists``,
the outer product's pre-pass), 32 at a time: A's fibers expand over the
tile's M window, B's over the chunk's k, into shared memory, and each chunk
is a rank-32 update (the chunked rank-update kernel of
``csrc/chunk_update.cuh``, shared with the SpMM and inner reference
bodies); a chunk where B holds nothing in the N tile skips its update.

``"auto"`` keeps the TPU's rule: sparse when ``4·cap_b <= K``.

Both bodies compute the same function; :func:`spgemm_gustavson_plain` is
its plain PyTorch version, which a wrapper runs for tensors on the CPU and
only then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.formats.ell import EllMatrix, ell_to_dense
from repro_torch.kernels import _build
from repro_torch.kernels.spgemm_outer import live_k_lists
from repro_torch.kernels.spmm import (
    REFERENCE_CHUNK,
    REFERENCE_TILE,
    fit_block,
)

#: Capacity-chunk width of the TPU body's live-chunk trip count over B's
#: fibers, passed as ``fc``; the sparse body here reads every slot.
GUSTAVSON_FIBER_CHUNK = 16

#: The sparse kernel's rows of ``Oᵀ`` a block (one a warp) and the M chunk
#: a warp holds in shared memory (``OS_ROWS``, ``OS_COLS`` in
#: ``csrc/row_merge.cuh``).
GUSTAVSON_SPARSE_ROWS = 8
GUSTAVSON_SPARSE_COLS = 1024

#: Kernel launches per body since the counts were last reset.
launches = {"gustavson_sparse": 0, "gustavson_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gustavson_sparse_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I,
                                _I, _P],
    "gustavson_reference_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                                   _P, _P, _I, _P, _I, _I, _I, _I, _P],
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
    N)`` in ``result_type(a.vals, b.vals)``. ``bm``, ``bn`` and ``bk`` are
    the JAX package's blocks and K step, accepted for the common signature
    (``bm`` and ``bn`` shrunk to divide ragged shapes, as there); no body
    here depends on them."""
    assert a.major_axis == 1 and b.major_axis == 1
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bm, bn = fit_block(m, bm), fit_block(n, bn)
    dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    if a.vals.dtype != dtype:
        a = dataclasses.replace(a, vals=a.vals.to(dtype))
    if b.vals.dtype != dtype:
        b = dataclasses.replace(b, vals=b.vals.to(dtype))
    if resolve_method(method, k, b.cap) == "sparse":
        return gustavson_sparse(a, b, bm=bm, bn=bn,
                                fc=min(GUSTAVSON_FIBER_CHUNK, b.cap))
    return gustavson_reference(a, b, bn=bn, bk=bk)


def spgemm_gustavson_plain(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """Plain PyTorch version of both bodies: both operands densified
    (``ell_to_dense``, which drops an id outside ``[0, minor_size)`` as the
    TPU's expansion does) and multiplied in f32. B is densified too rather
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


def gustavson_sparse_grid(m: int, n: int) -> tuple:
    """The sparse kernel's grid for an ``(M, K) x (K, N)`` launch: ``(row
    blocks, M chunks)``, blocks of :data:`GUSTAVSON_SPARSE_ROWS` of B's
    fibers (rows of ``Oᵀ``) times chunks of :data:`GUSTAVSON_SPARSE_COLS`
    of M, the last chunk ragged."""
    return (-(-n // GUSTAVSON_SPARSE_ROWS), -(-m // GUSTAVSON_SPARSE_COLS))


def gustavson_sparse(a: EllMatrix, b: EllMatrix, *, bm: int, bn: int,
                     fc: int) -> torch.Tensor:
    """The sparse body: the in-place row merge of B's fibers over A's on
    the card, or :func:`spgemm_gustavson_plain` for CPU tensors. ``bm``,
    ``bn`` and ``fc`` (the TPU body's M window, B's fiber block and its
    chunk) are accepted for the common signature and not used: the kernel
    reads every slot of B and merges A's runs per M chunk of its own."""
    if a.vals.device.type == "cpu":
        return spgemm_gustavson_plain(a, b)
    code = _check("gustavson_sparse", a, b)
    m, k = a.shape
    n = b.shape[1]
    if gustavson_sparse_grid(m, n)[1] > 65535:
        raise ValueError(f"gustavson_sparse: M={m} gives more than 65535 M "
                         "chunks (the grid's y extent)")
    dev = a.vals.device
    a_kind = torch.empty(k, dtype=torch.int32, device=dev)
    out_t = torch.empty((n, m), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_gustavson", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.gustavson_sparse_launch(
            P(a.vals), P(a.ids), P(a_kind), a.cap, P(b.vals), P(b.ids),
            b.cap, P(out_t), m, k, n, code, _build.stream(dev)),
            "gustavson_sparse")
    launches["gustavson_sparse"] += 1
    return out_t.T


def gustavson_reference(a: EllMatrix, b: EllMatrix, *, bn: int,
                        bk: int) -> torch.Tensor:
    """The reference body: live-K rank updates per output tile on the card
    (``spgemm_outer.live_k_lists``), or :func:`spgemm_gustavson_plain` for
    CPU tensors.

    The kernel reads A's entries in an M tile of an ordered or dense fiber
    (see ``spgemm_inner._ordered``) as one run of slots; it indexes a dense
    B fiber at slot k, reads an ordered one's run in an aligned chunk and
    merges it from a cursor in any other, and scans a fiber out of order
    whole. ``bn`` and ``bk`` are accepted
    for the common signature and not used: the tile and chunk are the
    kernel's own."""
    if a.vals.device.type == "cpu":
        return spgemm_gustavson_plain(a, b)
    return _gustavson_reference_launch(a, b)


def _gustavson_reference_launch(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    code = _check("gustavson_reference", a, b)
    m, k = a.shape
    n = b.shape[1]
    if -(-m // REFERENCE_TILE) > 65535:
        raise ValueError(f"gustavson_reference: M={m} gives more than 65535 "
                         "M tiles (the grid's y extent)")
    live_k, live_n, a_off = live_k_lists(a, REFERENCE_TILE)
    dev = a.vals.device
    kinds = torch.empty(k + n, dtype=torch.int32, device=dev)
    b_runs = torch.empty((-(-k // REFERENCE_CHUNK) + 1, n), dtype=torch.int32,
                         device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_gustavson", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.gustavson_reference_launch(
            P(a.vals), P(a.ids), P(a_off), P(kinds), a.cap, P(b.vals),
            P(b.ids), P(kinds[k:]), P(b_runs), b.cap, P(live_k), P(live_n),
            live_k.shape[1], P(out), m, k, n, code, _build.stream(dev)),
            "gustavson_reference")
    launches["gustavson_reference"] += 1
    return out
