"""ExTensor-like inner-product SpGEMM (U_M C_K, U_N C_K) on Hopper — the
port of ``repro.kernels.spgemm_inner``: ``a`` held as M row fibers (ids ->
K) times ``b`` held as N column fibers (ids -> K) gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spgemm_inner.cu``:

``method="sparse"`` (replaces ``_inner_sparse_kernel``) — builds no
table: the SpMM sparse body's row walk (``csrc/row_walk.cuh``) on the
mirrored product ``Oᵀ = Bᵀ·Aᵀ`` (:func:`inner_sparse_plan`). A block
expands a few of B's fibers into rows of shared memory (zeroed, then each
slot's value written at its id; every slot of B read once), and its
threads walk A's row fibers, copied slot-major by a pre-pass with the TPU
body's live bounds (``block_chunk_counts(a, bm, fc) · fc``), adding
``b[n, id] · val`` into f32 sums. The kernel stores ``Oᵀ`` and the wrapper
returns its ``(M, N)`` transposed view. A fiber block of A with no live
entry gives zeros.

``method="reference"`` — per 128 x 128 output tile, a walk over the k that
some row fiber of the M tile holds (:func:`live_k_rows`), 32 at a time:
both operands' fibers are merged over each chunk into shared memory and
applied as a rank-32 update (the chunked rank-update kernel of
``csrc/chunk_update.cuh``, shared with the SpMM and Gustavson reference
bodies); a chunk where B holds nothing in the N tile skips its update.

``"auto"`` keeps the TPU's rule: sparse when ``4·cap_a <= K``.

Both bodies compute the same function; :func:`spgemm_inner_plain` is its
plain PyTorch version, which a wrapper runs for tensors on the CPU and only
then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.formats.ell import PAD_ID, EllMatrix
from repro_torch.kernels import _build
from repro_torch.kernels.spgemm_outer import compact_live, tile_live_lists
from repro_torch.kernels.spmm import (
    REFERENCE_CHUNK,
    REFERENCE_TILE,
    SPMM_THREADS,
    SpmmPlan,
    fit_block,
    spmm_sparse_rows,
    spmm_sparse_split,
)

#: Capacity-chunk width of the live bound of each of A's fiber blocks in
#: the sparse body's walk: the block's longest fiber rounded up to it
#: (the TPU body's ``block_chunk_counts(a, bm, fc) · fc``).
INNER_FIBER_CHUNK = 16

#: The sparse body's walk per rows a block holds: ``(fibers a thread walks
#: in step, slots of each loaded at once)`` (``WalkShape`` of
#: ``RowLoad::kFibers`` in ``csrc/row_walk.cuh``). Its main-path launches
#: give a thread few but long fibers (bibd_81_3: 640 of A's rows of about
#: 20 slots for 256 threads; speech: 100-170 slots), so it walks fewer
#: fibers deeper than SpMM's 16 / rows one slot at a time, except at 2 rows
#: (m3plates: about one slot a fiber).
INNER_WALK = {1: (4, 4), 2: (8, 1), 4: (4, 2), 8: (2, 4), 16: (1, 4)}

#: Kernel launches per body since the counts were last reset.
launches = {"inner_sparse": 0, "inner_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "inner_sparse_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                            _P, _P] + [_I] * 8 + [_P],
    "inner_reference_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                               _P, _I, _P, _I, _I, _I, _I, _P],
    "fiber_scan_launch": [_P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P],
}


def resolve_method(method: str, k: int, cap_a: int) -> str:
    """The body ``method`` selects: ``"auto"`` is sparse while the gather
    volume (∝ ``cap_a``) undercuts the dense-K expansion it replaces."""
    if method == "auto":
        return "sparse" if 4 * cap_a <= k else "reference"
    if method in ("sparse", "reference"):
        return method
    raise ValueError(f"unknown spgemm_inner method: {method!r}")


def spgemm_inner(a: EllMatrix, b: EllMatrix, *, bm: int = 128,
                 bn: int = 128, bk: int = 128,
                 method: str = "auto") -> torch.Tensor:
    """A (M row fibers, ids->K) × B (N column fibers, ids->K) -> ``(M, N)``
    in ``result_type(a.vals, b.vals)``. ``bm`` is the fiber block of A's
    live bounds in the sparse body and shrinks to divide ragged shapes;
    ``bn`` and ``bk`` (the JAX package's N block and K step) are accepted
    and no body here depends on them."""
    assert a.major_axis == 0 and b.major_axis == 1
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bm, bn = fit_block(m, bm), fit_block(n, bn)
    dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    if a.vals.dtype != dtype:
        a = dataclasses.replace(a, vals=a.vals.to(dtype))
    if b.vals.dtype != dtype:
        b = dataclasses.replace(b, vals=b.vals.to(dtype))
    if resolve_method(method, k, a.cap) == "sparse":
        return inner_sparse(a, b, bm=bm, bn=bn, fc=INNER_FIBER_CHUNK)
    return inner_reference(a, b, bm=bm, bn=bn, bk=bk)


def spgemm_inner_plain(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """Plain PyTorch version of both bodies: B scattered to a dense ``(K,
    N)`` f32 table, then ``out[m, :] = Σ_c a.vals[m, c] · table[a.ids[m,
    c], :]`` over live slots (ids in ``[0, K)``; any other id is dropped,
    as the TPU's expansion drops it), in row chunks that bound the gathered
    ``(rows, cap, N)`` block."""
    (m, k), n = a.shape, b.shape[1]
    out_dtype = torch.promote_types(a.vals.dtype, b.vals.dtype)
    dev = a.vals.device
    table = torch.zeros((k + 1, n), dtype=torch.float32, device=dev)
    cols = torch.arange(b.n_fibers, device=dev)[:, None].expand_as(b.ids)
    b_live = (b.ids >= 0) & (b.ids < k)
    table.index_put_((torch.where(b_live, b.ids, k).long(), cols),
                     b.vals.float(), accumulate=True)
    table = table[:k]
    live = (a.ids >= 0) & (a.ids < k)
    safe = torch.where(live, a.ids, 0).long()
    vals = torch.where(live, a.vals.float(), 0.0)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    step = max(1, (1 << 26) // max(a.cap * n, 1))
    for m0 in range(0, m, step):
        m1 = min(m, m0 + step)
        g = table[safe[m0:m1]]                       # (rows, cap, N)
        out[m0:m1] = (vals[m0:m1, :, None] * g).sum(dim=1).to(out_dtype)
    return out


def _check(what: str, a: EllMatrix, b: EllMatrix) -> int:
    _build.require_cuda_operands(what, a.vals, a.ids, a.lens, b.vals, b.ids,
                                 b.lens)
    if any(t.dtype != torch.int32 for t in (a.ids, a.lens, b.ids, b.lens)):
        raise ValueError(f"{what}: ids and lens must be int32")
    if (a.major_axis, b.major_axis) != (0, 1) or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: shapes {a.shape} x {b.shape} (major axes "
                         f"{a.major_axis}, {b.major_axis})")
    return _build.dtype_code(what, a.vals.dtype, b.vals.dtype)


@functools.lru_cache(maxsize=None)
def inner_sparse_plan(m: int, k: int, n: int, elem: int,
                      sms: int) -> SpmmPlan:
    """The sparse body's launch plan for ``(M, K) x (K, N)``: SpMM
    sparse's plan of the mirrored product, whose rows are B's ``n`` fibers
    (:func:`spmm.spmm_sparse_rows`) and whose walked fibers are A's ``m``
    rows, in passes of :data:`INNER_WALK`'s fibers a thread, split by
    :func:`spmm.spmm_sparse_split` on the card's ``sms`` SMs. Where the
    rows leave SMs idle (speech: 48 row blocks), blocks that share an SM
    divide its shared-memory bandwidth, so the launch ends with the SM
    that runs the most passes, not with the waves of its block slots."""
    rows, window = spmm_sparse_rows(n, k, elem)
    pass_w = SPMM_THREADS * INNER_WALK[rows][0]
    n_split, split_w = spmm_sparse_split(-(-n // rows), m, pass_w, sms)
    return SpmmPlan(rows, window, n_split, split_w, pass_w)


def fiber_vec(e: EllMatrix) -> int:
    """Slots the sparse body reads a load from ``e``'s fibers: 4 where
    every fiber's ids and values start 4-slot aligned (the capacity a
    multiple of 4, both arrays aligned), else 1."""
    elem = e.vals.element_size()
    if (e.cap % 4 == 0 and e.ids.data_ptr() % 16 == 0
            and e.vals.data_ptr() % (4 * elem) == 0):
        return 4
    return 1


def inner_sparse(a: EllMatrix, b: EllMatrix, *, bm: int, bn: int,
                 fc: int) -> torch.Tensor:
    """The sparse body: B's fibers expanded into the rows of the row walk
    and A's row fibers walked (:func:`inner_sparse_plan`) on the card, or
    :func:`spgemm_inner_plain` for CPU tensors. ``bm`` (which must divide
    M) and ``fc`` give A's live bounds; ``bn`` is accepted for the common
    signature and not used: every slot of B is read."""
    if a.vals.device.type == "cpu":
        return spgemm_inner_plain(a, b)
    code = _check("inner_sparse", a, b)
    (m, k), n = a.shape, b.shape[1]
    if m % bm:
        raise ValueError(f"inner_sparse: {m} fibers not a multiple of "
                         f"bm={bm}")
    dev = a.vals.device
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=a.vals.dtype, device=dev)
    plan = inner_sparse_plan(m, k, n, a.vals.element_size(),
                             _build.sm_count(dev))
    # A slot-major: (cap, m) ids, then each fiber's end; (cap, m) values.
    cap = a.cap
    ids_t = torch.empty((cap + 1) * m, dtype=torch.int32, device=dev)
    ends = ctypes.c_void_p(ids_t.data_ptr() + cap * m * 4)
    vals_t = torch.empty((cap, m), dtype=a.vals.dtype, device=dev)
    out_t = torch.empty((n, m), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_inner", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.inner_sparse_launch(
            P(a.vals), P(a.ids), P(a.lens), cap, bm, max(1, min(fc, cap)),
            P(b.vals), P(b.ids), b.cap, fiber_vec(b), P(ids_t), P(vals_t),
            ends, P(out_t), m, k, n, plan.rows, plan.window, plan.split_w,
            plan.n_split, code, _build.stream(dev)), "inner_sparse")
    launches["inner_sparse"] += 1
    return out_t.T


def _ordered(e: EllMatrix) -> torch.Tensor:
    """``(n_fibers,)`` bool: the fiber's live ids lie in ``[0,
    minor_size)`` and ascend, and its PAD slots come last, as
    ``dense_to_ell`` writes them (``ell_from_numpy`` does not promise it).
    Computed on the device, with no host sync."""
    in_range = ((e.ids >= PAD_ID) & (e.ids < e.minor_size)).all(dim=1)
    key = torch.where(e.ids >= 0, e.ids, e.minor_size)  # PAD sorts last
    return in_range & (key[:, 1:] >= key[:, :-1]).all(dim=1)


def live_k_rows(a: EllMatrix) -> tuple:
    """The reference body's walk over A (M row fibers, ids -> K): per M
    tile of :data:`spmm.REFERENCE_TILE` rows, the ascending k some row of
    the tile holds, ``(live_k (T, K + 1), live_n (T,))`` int32 (see
    ``spgemm_outer.tile_live_lists``). The plain version of the wrapper's
    pre-pass, which flags the k in the launch's fiber scan on the card and
    compacts the flags with ``compact_live``."""
    return tile_live_lists(a, REFERENCE_TILE)


def inner_reference(a: EllMatrix, b: EllMatrix, *, bm: int, bn: int,
                    bk: int) -> torch.Tensor:
    """The reference body: live-k rank updates per output tile on the card
    (:func:`live_k_rows`), or :func:`spgemm_inner_plain` for CPU tensors.

    The kernel merges an ordered fiber (see :func:`_ordered`) over each
    chunk from a cursor, indexes a dense one at slot k and scans a fiber
    out of order whole. ``bm``, ``bn`` and ``bk`` are accepted for the
    common signature and not used: the tile and chunk are the kernel's
    own."""
    if a.vals.device.type == "cpu":
        return spgemm_inner_plain(a, b)
    return _inner_reference_launch(a, b)


def _inner_reference_launch(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    code = _check("inner_reference", a, b)
    (m, k), n = a.shape, b.shape[1]
    if -(-m // REFERENCE_TILE) > 65535:
        raise ValueError(f"inner_reference: M={m} gives more than 65535 M "
                         "tiles (the grid's y extent)")
    n_chunks = -(-k // REFERENCE_CHUNK)
    dev = a.vals.device
    kinds = torch.empty(m + n, dtype=torch.int32, device=dev)
    a_runs = torch.empty((n_chunks + 1, m), dtype=torch.int32, device=dev)
    b_runs = torch.empty((n_chunks + 1, n), dtype=torch.int32, device=dev)
    flags = torch.zeros((-(-m // REFERENCE_TILE), k), dtype=torch.uint8,
                        device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_inner", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        # A's kinds, runs and each M tile's live k (flags), then the lists.
        _build.check(lib.fiber_scan_launch(
            P(a.ids), m, a.cap, k, P(kinds), P(a_runs), REFERENCE_CHUNK,
            P(flags), REFERENCE_TILE, 1, _build.stream(dev)),
            "inner_reference (fiber scan)")
        live_k, live_n = compact_live(flags.bool())
        _build.check(lib.inner_reference_launch(
            P(a.vals), P(a.ids), P(kinds), P(a_runs), a.cap, P(b.vals),
            P(b.ids), P(kinds[m:]), P(b_runs), b.cap, P(live_k), P(live_n),
            live_k.shape[1], P(out), m, k, n, code, _build.stream(dev)),
            "inner_reference")
    launches["inner_reference"] += 1
    return out
