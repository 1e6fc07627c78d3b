"""EIE-like SpMM (U_M U_K, U_N C_K) on Hopper — the port of
``repro.kernels.spmm``: dense ``a (M, K)`` times ``b`` held as N column
fibers (ids -> K) gives ``(M, N)``.

Two bodies behind one entry point, as in the JAX package, each a CUDA
kernel in ``csrc/spmm.cu``:

``method="sparse"`` (replaces ``_spmm_sparse_kernel``) — builds no table
and runs no dense contraction: a block copies a few whole rows of A into
shared memory (row-stationary, held k-major; :func:`spmm_sparse_plan`),
and each of its threads walks its fibers' live slots in order, adding
``a[m, id] · val`` into f32 sums for those rows, so the work is
``2·M·nnz(B)`` and the bytes A read about once and the output written
once. A pre-pass copies B's fibers slot-major, so that a warp reads one
slot of 32 fibers at once. A row too long for shared memory is walked in
K windows. Fiber blocks with no live chunk write zeros. Bound: the bytes
at Table I's sparse mirrored launches, shared-memory reads of A (one a
FMA, at random banks) where the fibers are long.

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
import functools
import math

import torch

from repro_torch.formats.ell import EllMatrix
from repro_torch.kernels import _build
from repro_torch.kernels.spgemm_outer import tile_live_lists

#: Capacity-chunk width of the live bound of each fiber block's walk: the
#: block's longest fiber rounded up to it (``block_chunk_counts(b, bn,
#: fc) · fc`` with ``fc = min(SPMM_FIBER_CHUNK, cap)``, the TPU body's
#: bound), computed on the card by the pre-pass.
SPMM_FIBER_CHUNK = 64

#: The sparse body's shared memory for A's rows, per block: at most 96 KB,
#: so that two blocks share an SM. Rows of A a block holds: a power of two
#: up to :data:`SPMM_SUMS`; a thread keeps ``SPMM_SUMS`` f32 sums, for
#: ``SPMM_SUMS // rows`` fibers walked in step (one kernel instance per
#: row count, ``SP_SUMS`` in ``csrc/spmm.cu``).
SPMM_ROWS_BYTES = 96 * 1024
SPMM_SUMS = 16

#: Threads of a sparse-body block (``SP_THREADS``).
SPMM_THREADS = 256

#: The reference kernel's output tile (``CU_N`` in ``csrc/chunk_update.cuh``)
#: and the K chunk of its rank updates (``CU_KC``): its live-chunk lists are
#: per N tile of this width.
REFERENCE_TILE = 128
REFERENCE_CHUNK = 32

#: Kernel launches per body since the counts were last reset.
launches = {"spmm_sparse": 0, "spmm_reference": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmm_sparse_launch": [_P] * 8 + [_I] * 12 + [_P],
    "spmm_sparse_blocks_per_sm": [_I, _I, _I, _P],
    "spmm_reference_launch": [_P] * 6 + [_I] + [_P] + [_I] * 5 + [_P],
}

#: Sparse-body block slots (SMs x blocks per SM) per (device index, rows,
#: shared-memory bytes, dtype code).
_slots = {}


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


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """How the sparse body covers an ``(M, K) x (K, N)`` launch: blocks of
    ``rows`` rows of A holding ``window`` of their K columns at once (all
    of them unless K is too long), times ``n_split`` ranges of
    ``split_w`` fibers, which a block walks ``pass_w`` at a time
    (``SPMM_SUMS // rows`` fibers a thread)."""

    rows: int
    window: int
    n_split: int
    split_w: int
    pass_w: int

    def smem_bytes(self, elem: int) -> int:
        return self.rows * self.window * elem

    def blocks(self, m: int) -> int:
        return -(-m // self.rows) * self.n_split


def spmm_sparse_rows(m: int, k: int, elem: int) -> tuple:
    """``(rows, window)`` of the sparse body for A of ``elem``-byte
    elements: the most whole rows of A that fit :data:`SPMM_ROWS_BYTES`,
    rounded down to a power of two up to :data:`SPMM_SUMS` (and to the
    power of two that covers ``m``), with all K; or, when one row does not
    fit, one row and a K window of the most 16-element multiples that do."""
    assert m >= 1 and k >= 1 and elem >= 1
    row_bytes = k * elem
    if row_bytes > SPMM_ROWS_BYTES:
        return 1, SPMM_ROWS_BYTES // elem // 16 * 16
    fit = min(SPMM_ROWS_BYTES // row_bytes, SPMM_SUMS,
              1 << (m - 1).bit_length())
    return 1 << (fit.bit_length() - 1), k


@functools.lru_cache(maxsize=None)
def spmm_sparse_split(row_blocks: int, n: int, pass_w: int,
                      slots: int) -> tuple:
    """``(n_split, split_w)``: N whole, or, when the row blocks alone do
    not fill the ``slots`` block slots of the card, cut into ranges of
    whole passes of ``pass_w`` fibers, the split whose launch ends soonest.
    A block's time goes with its passes, so a split costs ``ceil(blocks /
    slots)`` waves times the passes of a range; of equal costs the one
    with fewer blocks (A's rows copied fewer times) wins."""
    assert row_blocks >= 1 and n >= 1 and pass_w >= 1 and slots >= 1
    best = None
    most = max(1, n // pass_w) if row_blocks < slots else 1
    for want in range(1, most + 1):
        per_range = -(-n // want)
        passes = -(-per_range // pass_w)
        split_w = passes * pass_w
        n_split = -(-n // split_w)
        cost = (-(-row_blocks * n_split // slots) * passes, n_split)
        if best is None or cost < best[0]:
            best = (cost, n_split, split_w)
    return best[1], best[2]


def spmm_sparse_plan(m: int, k: int, n: int, elem: int,
                     slots_for) -> SpmmPlan:
    """The sparse body's launch plan: :func:`spmm_sparse_rows`, then
    :func:`spmm_sparse_split` on ``slots_for(rows, smem_bytes)`` block
    slots (the card's SMs times the blocks of that size one SM holds)."""
    rows, window = spmm_sparse_rows(m, k, elem)
    pass_w = SPMM_THREADS * (SPMM_SUMS // rows)
    n_split, split_w = spmm_sparse_split(
        -(-m // rows), n, pass_w, slots_for(rows, rows * window * elem))
    return SpmmPlan(rows, window, n_split, split_w, pass_w)


def block_slots(device: torch.device, code: int, rows: int,
                smem: int) -> int:
    """Sparse-body blocks of ``rows`` rows and ``smem`` bytes of shared
    memory the card runs at once: its SMs times the blocks one SM holds
    (asked of the runtime once per device, shape and dtype)."""
    key = (device.index, rows, smem, code)
    if key not in _slots:
        lib = _build.load("spmm", _SIGNATURES)
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.spmm_sparse_blocks_per_sm(
                rows, smem, code, ctypes.byref(per_sm)), "spmm occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _slots[key] = max(1, per_sm.value) * sms
    return _slots[key]


def spmm(a: torch.Tensor, b: EllMatrix, *, bn: int = 128,
         method: str = "auto") -> torch.Tensor:
    """Dense ``a (M, K)`` × compressed ``b`` (column fibers, ids->K) ->
    ``(M, N)`` in ``result_type(a, b.vals)``. Blocks auto-shrink to divide
    ragged shapes; ``bn`` is the fiber block over which the sparse body
    takes its live bound (the CUDA tiles themselves are fixed)."""
    assert b.major_axis == 1, "spmm expects B in U_N C_K (column fibers)"
    m, k = a.shape
    kb, n = b.shape
    assert k == kb, (a.shape, b.shape)
    bn = fit_block(n, bn)
    dtype = torch.promote_types(a.dtype, b.vals.dtype)
    a = a.to(dtype)
    if b.vals.dtype != dtype:
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


def _check(what: str, a: torch.Tensor, b: EllMatrix) -> int:
    _build.require_cuda_operands(what, a, b.vals, b.ids, b.lens)
    if b.ids.dtype != torch.int32 or b.lens.dtype != torch.int32:
        raise ValueError(f"{what}: ids and lens must be int32")
    if a.ndim != 2 or a.shape[1] != b.shape[0] or b.major_axis != 1:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} x {b.shape} "
                         f"(major_axis {b.major_axis})")
    return _build.dtype_code(what, a.dtype, b.vals.dtype)


def spmm_sparse(a: torch.Tensor, b: EllMatrix, *, bn: int) -> torch.Tensor:
    """The sparse body: row-stationary A and a walk of B's live slots on
    the card (:func:`spmm_sparse_plan`), or :func:`spmm_plain` for CPU
    tensors."""
    if a.device.type == "cpu":
        return spmm_plain(a, b)
    code = _check("spmm_sparse", a, b)
    m, k = a.shape
    n, cap = b.n_fibers, b.cap
    if n % bn:
        raise ValueError(f"spmm_sparse: {n} fibers not a multiple of bn={bn}")
    dev = a.device
    if m == 0 or k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=dev)
    plan = spmm_sparse_plan(
        m, k, n, a.element_size(),
        lambda rows, smem: block_slots(dev, code, rows, smem))
    # B slot-major: (cap, n) ids, then each fiber's end; (cap, n) values.
    ids_t = torch.empty((cap + 1) * n, dtype=torch.int32, device=dev)
    ends = ctypes.c_void_p(ids_t.data_ptr() + cap * n * 4)
    vals_t = torch.empty((cap, n), dtype=a.dtype, device=dev)
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.spmm_sparse_launch(
            P(a), P(b.vals), P(b.ids), P(b.lens), P(ids_t), P(vals_t),
            ends, P(out), m, k, n, cap, bn, min(SPMM_FIBER_CHUNK, cap),
            plan.rows, plan.window,
            plan.split_w, plan.n_split, _build.row_granule(a), code,
            _build.stream(dev)), "spmm_sparse")
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
            cap, P(out), m, k, n, _build.row_granule(a), code,
            _build.stream(dev)),
            "spmm_reference")
    launches["spmm_reference"] += 1
    return out
