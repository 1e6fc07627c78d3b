"""OuterSPACE-like outer-product SpGEMM (U_K C_M, U_K C_N) on Hopper — the
port of ``repro.kernels.spgemm_outer``: ``a`` held as K fibers (ids -> M)
times ``b`` held as K fibers (ids -> N) gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spgemm_outer.cu``. Both TPU bodies spend their work on
``K·(M + N)``: dense tables, or every fiber scanned for every tile. Here
each body's work goes with the data.

``method="sparse"`` (replaces ``_outer_sparse_kernel``) — OuterSPACE's
multiply and merge with no dense tables: A's slots sorted into row order
(:func:`a_row_order`, read by the kernel through the sort's permutation),
then a warp per output row adds ``v·B[k, :]`` for each of the row's
entries ``(k, v)`` into f32 accumulators in shared memory, over B fiber
``k``'s slots in a column chunk of :data:`OUTER_SPARSE_COLS`. The work is
the ``(a, b)`` pair count (a shared-memory add and a read of B's run
each) plus one write of the output, where the TPU body's dense tables
cost ``2·M·N·K``; no float atomics, and two runs give the same bits.
``bm`` and ``bn`` are not used: the row group (8) and column chunk are
the kernel's own.

``method="reference"`` (replaces ``_outer_reference_kernel``) — per 128 x
128 output tile, the kernel walks only its M tile's live K fibers
(:func:`live_k_lists`) in chunks of 32, expands A's slots in the tile and
B's slots in the N window (a binary-searched run, see
:func:`warp_lower_bound`) into shared memory and applies a rank-32 update;
chunks where B has no entry in the window skip it. The TPU body's
``K·(cap_a + cap_b)`` slot scan per tile is gone: at sparse A the reads
of B's window slices and the output write bound it, at dense data the
f32 FMA rate and the latency of each chunk's expansion.

Both bodies read an ordered fiber (live ids ascending, PAD slots last) by
slot ranges and scan a fiber out of order whole, each id tested. A kernel
in the launch sorts the fibers into these kinds (``spgemm_inner._ordered``'s
test), and marks a fiber whose ids are its slots ``0..L-1``: its window
``[x0, x1)`` is the slots ``[min(x0, L), min(x1, L))``, with no search.
The pre-passes are torch ops on the card with fixed-size outputs and no
host sync.

``"auto"`` keeps the TPU's rule: sparse while both of the TPU body's
tables fit :data:`OUTER_TABLE_BYTES_MAX`.

Both bodies compute the same function; :func:`spgemm_outer_plain` is its
plain PyTorch version, which a wrapper runs for tensors on the CPU and only
then. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.formats.ell import EllMatrix
from repro_torch.kernels import _build

#: The TPU sparse body's budget for its two f32 tables, ``4·K·(M+N)``
#: bytes of VMEM. This body keeps no tables; the budget stays the "auto"
#: rule so that both packages pick the same body.
OUTER_TABLE_BYTES_MAX = 8 << 20

#: The reference kernel's output tile (``OR_M`` in the CUDA source): its
#: live-K lists and A's slot ranges are per M tile of this height.
OUTER_REFERENCE_TILE_M = 128

#: Live K fibers the reference kernel expands per rank update
#: (``OR_KC``), and lanes per warp of the binary search.
OUTER_REFERENCE_CHUNK = 32
WARP = 32

#: The sparse kernel's column chunk (``OS_COLS``): the output columns its
#: warps hold in shared memory, one output row a warp.
OUTER_SPARSE_COLS = 1024

#: Kernel launches per body since the counts were last reset.
launches = {"outer_sparse": 0, "outer_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "outer_sparse_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _P,
                            _I, _I, _I, _I, _P],
    "outer_reference_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                               _I, _P, _I, _I, _I, _I, _P],
}


def resolve_method(method: str, m: int, k: int, n: int) -> str:
    """The body ``method`` selects: ``"auto"`` is sparse while the TPU
    body's resident tables would fit :data:`OUTER_TABLE_BYTES_MAX`."""
    if method == "auto":
        fits = 4 * k * (m + n) <= OUTER_TABLE_BYTES_MAX
        return "sparse" if fits else "reference"
    if method in ("sparse", "reference"):
        return method
    raise ValueError(f"unknown spgemm_outer method: {method!r}")


def spgemm_outer(a: EllMatrix, b: EllMatrix, *, bm: int = 128,
                 bn: int = 128, method: str = "auto") -> torch.Tensor:
    """A (K column-fibers, ids->M) × B (K row-fibers, ids->N) -> ``(M, N)``
    in ``result_type(a.vals, b.vals)``. ``bm``/``bn`` are the JAX
    package's block sizes; neither body here depends on them."""
    assert a.major_axis == 1 and b.major_axis == 0
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
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


# ------------------------------------------------------------- pre-passes
def compact_live(live: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, X)`` bool -> ``(lists, counts)``: row ``t`` of ``lists`` ``(T,
    X + 1)`` int32 starts with the ascending ``x`` where ``live[t, x]``
    (the rest is unused), and ``counts`` ``(T,)`` int32 says how many. A
    cumsum and a scatter on the device, no host sync."""
    t, x = live.shape
    dev = live.device
    counts = live.sum(dim=1, dtype=torch.int32)
    dest = torch.where(live, torch.cumsum(live, dim=1) - 1, x)
    lists = torch.zeros((t, x + 1), dtype=torch.int32, device=dev)
    lists.scatter_(1, dest, torch.arange(x, dtype=torch.int32,
                                         device=dev).expand(t, x))
    return lists, counts


def tile_live_lists(e: EllMatrix, tile: int, group: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per tile of ``tile`` consecutive fibers of ``e``, the ascending
    minor groups (``id // group``) that some fiber of the tile holds, as
    :func:`compact_live` gives them: ``(T, G + 1)`` and ``(T,)`` int32 with
    ``T = ceil(n_fibers / tile)`` and ``G = ceil(minor_size / group)``.
    Ids outside ``[0, minor_size)`` are dropped, PAD among them. The
    inner reference body walks its M tiles' live k (``group`` 1), SpMM's
    its N tiles' live K chunks. A scatter into a fixed-size buffer: no
    host sync."""
    nf, minor = e.n_fibers, e.minor_size
    n_tiles = -(-nf // tile)
    n_groups = -(-minor // group)
    dev = e.ids.device
    key = torch.where((e.ids >= 0) & (e.ids < minor),
                      torch.div(e.ids, group, rounding_mode="floor"),
                      n_groups).long()
    row = torch.div(torch.arange(nf, device=dev), tile,
                    rounding_mode="floor")[:, None]
    live = torch.zeros((n_tiles, n_groups + 1), dtype=torch.bool, device=dev)
    live.view(-1).scatter_(0, (row * (n_groups + 1) + key).reshape(-1), True)
    return compact_live(live[:, :n_groups])


def fiber_chunk_starts(e: EllMatrix, chunk: int) -> torch.Tensor:
    """``(ceil(minor_size / chunk) + 1, n_fibers)`` int32: row ``q`` holds,
    per fiber, the first slot whose id is at least ``q·chunk`` (PAD and ids
    outside ``[0, minor_size)`` count as past every chunk), so an ordered
    fiber's entries in chunk ``q`` are the slots ``[row q, row q + 1)``
    (unused for a fiber out of order). A sorted search on the device, no
    host sync. The plain version of the starts that the reference bodies'
    fiber scan (``csrc/fiber_search.cuh``) writes on the card, in the same
    layout (fiber-contiguous rows, so a warp reads 16 fibers' starts in one
    access)."""
    nf, minor = e.n_fibers, e.minor_size
    n_chunks = -(-minor // chunk)
    key = torch.where((e.ids >= 0) & (e.ids < minor), e.ids, minor)
    bounds = torch.arange(0, (n_chunks + 1) * chunk, chunk, dtype=key.dtype,
                          device=key.device).clamp_(max=minor)
    starts = torch.searchsorted(key, bounds.expand(nf, -1).contiguous(),
                                out_int32=True)
    return starts.T.contiguous()


def live_k_lists(a: EllMatrix, tile: int = OUTER_REFERENCE_TILE_M
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference body's walk over A (K fibers, ids -> M), per M tile of
    ``tile`` rows (``T = ceil(M / tile)`` tiles):

    * ``live_k`` ``(T, K + 1)`` int32: row ``t`` starts with the k whose
      fiber holds an entry in tile ``t``, ascending (the rest is unused);
    * ``live_n`` ``(T,)`` int32: how many;
    * ``a_off`` ``(K, T + 1)`` int32: for an ordered fiber ``k`` (see
      ``spgemm_inner._ordered``), its entries in tile ``t`` are the slots
      ``[a_off[k, t], a_off[k, t + 1])`` (a sorted search; unused for a
      fiber out of order, which the kernel scans).

    Fixed-size torch ops whose work goes with A's ELL size and ``T·K``, and
    no host sync (so no ``bincount``, which reads its input's range back).
    """
    m, k = a.shape
    n_tiles = -(-m // tile)
    dev = a.ids.device
    # A slot's key: its id, or past every tile for PAD or an id out of range.
    key = torch.where((a.ids >= 0) & (a.ids < m), a.ids, n_tiles * tile)
    live = torch.zeros((k, n_tiles + 1), dtype=torch.bool, device=dev)
    live.scatter_(1, torch.div(key, tile, rounding_mode="floor").long(), True)
    live_k, live_n = compact_live(live[:, :n_tiles].T)
    bounds = torch.arange(0, (n_tiles + 1) * tile, tile, dtype=torch.int32,
                          device=dev).clamp_(max=m)
    a_off = torch.searchsorted(key, bounds.expand(k, -1).contiguous(),
                               out_int32=True)
    return live_k, live_n, a_off


def a_row_order(a: EllMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse body's transposition of A (K fibers, ids -> M) into row
    order: ``order`` (int64, over A's flattened slots) is a stable sort of
    the slots by id, and ``row_ptr`` ``(M + 1,)`` int32 is where each row
    starts in it, so row ``m``'s entries are the slots ``order[row_ptr[m]:
    row_ptr[m + 1]]``, ascending in k (slot ``s`` is fiber ``s // cap``).
    PAD slots sort first and ids past M last, outside every row. A's ELL
    size, three device ops, no host sync."""
    m = a.shape[0]
    ids, order = torch.sort(a.ids.reshape(-1), stable=True)
    rows = torch.arange(m + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, rows, out_int32=True), order


def warp_lower_bound(ids, lo: int, hi: int, x: int) -> int:
    """The kernels' binary search (``warp_lower_bounds`` in the CUDA
    source), in Python for the tests: the first slot in ``[lo, hi)`` of
    an ordered fiber ``ids`` whose key (the id; PAD counts as +inf) is
    ``>= x``, or ``hi``. Each step the 32 lanes probe 32 evenly spaced
    slots, and the gap between the last probe below ``x`` and the first
    at or above it is the next range."""
    while hi > lo:
        stride = -(-(hi - lo) // WARP)
        ge = [p >= hi or ids[p] < 0 or ids[p] >= x
              for p in range(lo, lo + WARP * stride, stride)]
        if not any(ge):
            lo += (WARP - 1) * stride + 1
        else:
            f = ge.index(True)
            new_hi = min(hi, lo + f * stride)
            if f > 0:
                lo += (f - 1) * stride + 1
            hi = new_hi
    return lo


def fiber_window(ids, x0: int, x1: int) -> Tuple[int, int]:
    """The slots ``[s0, s1)`` of an ordered fiber whose ids lie in ``[x0,
    x1)``, as the kernels find them: two :func:`warp_lower_bound`
    searches over the whole fiber."""
    cap = len(ids)
    return (warp_lower_bound(ids, 0, cap, x0),
            warp_lower_bound(ids, 0, cap, x1))


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
    """The sparse body: A's row order (:func:`a_row_order`) and the row
    merge on the card, or :func:`spgemm_outer_plain` for CPU tensors.
    ``bm``/``bn`` are accepted for the common signature and not used."""
    if a.vals.device.type == "cpu":
        return spgemm_outer_plain(a, b)
    code = _check("outer_sparse", a, b)
    (m, k), n = a.shape, b.shape[1]
    dev = a.vals.device
    row_ptr, order = a_row_order(a)
    b_kind = torch.empty(k, dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_outer", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.outer_sparse_launch(
            P(row_ptr), P(order), P(a.vals), a.cap, P(b.vals), P(b.ids),
            P(b_kind), b.cap, P(out), m, k, n, code, _build.stream(dev)),
            "outer_sparse")
    launches["outer_sparse"] += 1
    return out


def outer_reference(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """The reference body: live-K rank updates per output tile on the
    card (:func:`live_k_lists`), or :func:`spgemm_outer_plain` for CPU
    tensors."""
    if a.vals.device.type == "cpu":
        return spgemm_outer_plain(a, b)
    code = _check("outer_reference", a, b)
    (m, k), n = a.shape, b.shape[1]
    n_tiles = -(-m // OUTER_REFERENCE_TILE_M)
    if n_tiles > 65535:
        raise ValueError(f"outer_reference: M={m} gives {n_tiles} M tiles "
                         "(the grid's y extent is at most 65535)")
    dev = a.vals.device
    live_k, live_n, a_off = live_k_lists(a)
    kinds = torch.empty(2 * k, dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=a.vals.dtype, device=dev)
    lib = _build.load("spgemm_outer", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.outer_reference_launch(
            P(a.vals), P(a.ids), P(a_off), P(kinds), a.cap, P(b.vals),
            P(b.ids), P(kinds[k:]), b.cap, P(live_k), P(live_n),
            live_k.shape[1], P(out), m, k, n, code, _build.stream(dev)),
            "outer_reference")
    launches["outer_reference"] += 1
    return out
