"""Launch planning of the port's row walk (the SpMM and inner sparse
bodies), row merge (the Gustavson sparse body) and dense GEMM.

Pure functions of shapes (``spmm.spmm_sparse_plan``,
``spgemm_inner.inner_sparse_plan``, ``spgemm_gustavson.
gustavson_sparse_grid``, ``gemm.gemm_plan``, ``_build.row_granule``,
``spgemm_inner.fiber_vec``, ``ell_convert.ell_convert_plan``): what
each CUDA launch covers, checked on the CPU against the limits the
kernels rely on. The kernels themselves run only on the card
(``chip_smoke.py``).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.formats import ell as tell
from repro_torch.kernels import _build
from repro_torch.kernels import ell_convert as tec
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import spgemm_gustavson as tgust
from repro_torch.kernels import spgemm_inner as tinner
from repro_torch.kernels import spmm as tspmm

#: Shared memory one block may use on the H100 (bytes), and the SMs.
H100_BLOCK_SMEM = 232_448
SMS = 132

#: CUDA's grid limits: x up to 2^31 - 1 blocks, y up to 65535.
GRID_X_MAX = 2**31 - 1
GRID_Y_MAX = 65535


def slots_for(rows, smem):
    """A model of the card's block slots for the sparse body: 228 KB of
    shared memory an SM, 1 KB of it reserved a block, at most 8 blocks of
    256 threads (the wrapper asks the CUDA runtime instead)."""
    return SMS * min(8, 233_472 // (smem + 1024))

#: (m, k, n) of the sparse body's main-path launches (mirrored SpMM after
#: the ops layer's padding: chem97ZtZ, m3plates, bibd_81_3 reduced, speech
#: n[0:975] and n[0:1300], opt speech) and of small and ragged ones.
SPMM_SHAPES = [
    (1280, 2500, 2560), (5504, 11000, 11008), (8320, 16288, 640),
    (1024, 2600, 7808), (1408, 2600, 7808), (512, 1950, 7808),
    (203, 300, 384), (40, 300, 4096), (130, 50000, 384), (1, 1, 1),
    (7, 24577, 33), (1000, 24576, 256),
]
ELEMS = [4, 2]


@pytest.mark.parametrize("m,k,n", SPMM_SHAPES)
@pytest.mark.parametrize("elem", ELEMS)
def test_spmm_plan_fits_and_covers(m, k, n, elem):
    """Every plan fits its shared-memory budget (and so the card's), gives
    each block at least one row and one fiber, and covers every row and
    fiber exactly once."""
    plan = tspmm.spmm_sparse_plan(m, k, n, elem, slots_for)
    assert plan.smem_bytes(elem) <= tspmm.SPMM_ROWS_BYTES <= H100_BLOCK_SMEM
    assert 1 <= plan.rows <= tspmm.SPMM_SUMS
    assert plan.rows & (plan.rows - 1) == 0          # one kernel instance each
    assert plan.rows <= 1 << (m - 1).bit_length()    # no rows past M twice
    assert 1 <= plan.window <= k
    # Ranges of fibers: none empty, together exactly [0, n).
    assert plan.split_w >= 1 and plan.n_split >= 1
    assert (plan.n_split - 1) * plan.split_w < n <= plan.n_split * plan.split_w
    assert plan.blocks(m) == -(-m // plan.rows) * plan.n_split


@pytest.mark.parametrize("elem", ELEMS)
def test_spmm_plan_windows_exactly_when_a_row_does_not_fit(elem):
    """The K-window walk starts at the first K whose row of A no longer
    fits the block's shared memory, and then holds one row and a window of
    16-element multiples."""
    last_whole = tspmm.SPMM_ROWS_BYTES // elem
    rows, window = tspmm.spmm_sparse_rows(64, last_whole, elem)
    assert window == last_whole
    rows, window = tspmm.spmm_sparse_rows(64, last_whole + 1, elem)
    assert window < last_whole + 1
    assert rows == 1
    assert window % 16 == 0
    assert window * elem <= tspmm.SPMM_ROWS_BYTES


@pytest.mark.parametrize("k,elem,rows", [
    (11000, 4, 2), (16288, 4, 1), (2500, 4, 8), (2600, 4, 8), (1950, 4, 8),
    (300, 4, 16), (16288, 2, 2), (2600, 2, 16), (24576, 4, 1),
])
def test_spmm_plan_rows_from_k(k, elem, rows):
    """Rows a block holds: the most whole rows within the budget, rounded
    down to a power of two (m3plates 2, bibd_81_3 1, chem97ZtZ and speech
    8 in f32)."""
    assert tspmm.spmm_sparse_rows(4096, k, elem)[0] == rows


@pytest.mark.parametrize("m,k,n,n_split", [
    (5504, 11000, 11008, 1),     # m3plates: 2752 row blocks fill the card
    (8320, 16288, 640, 1),       # bibd_81_3: one pass of fibers
    (1024, 2600, 7808, 2),       # speech: 128 row blocks, one wave of 256
    (1408, 2600, 7808, 3),       # sjf speech: 176 row blocks, two waves
    (512, 1950, 7808, 6),        # opt speech: 64 row blocks, one wave
    (1280, 2500, 2560, 3),       # chem97ZtZ: 160 row blocks
    (40, 300, 4096, 16),         # three row blocks, the fibers split
    (40, 300, 200, 1),           # fewer fibers than one pass
])
def test_spmm_plan_n_split(m, k, n, n_split):
    """The main-path launches' N splits on the modelled H100."""
    plan = tspmm.spmm_sparse_plan(m, k, n, 4, slots_for)
    assert plan.n_split == n_split
    if plan.n_split > 1:
        assert plan.split_w % plan.pass_w == 0


@pytest.mark.parametrize("row_blocks", [1, 3, 64, 128, 263, 264, 5000])
@pytest.mark.parametrize("n", [200, 640, 7808, 11008])
@pytest.mark.parametrize("pass_w", [256, 512, 4096])
def test_spmm_split_is_the_cheapest(row_blocks, n, pass_w):
    """No split while the row blocks alone fill the card's 264 slots;
    otherwise no range count of whole passes gives fewer waves times
    passes, and of equal costs the fewest blocks were taken."""
    slots = 264
    n_split, split_w = tspmm.spmm_sparse_split(row_blocks, n, pass_w, slots)
    assert (n_split - 1) * split_w < n <= n_split * split_w
    assert split_w % pass_w == 0
    if row_blocks >= slots:
        assert n_split == 1
        return

    def cost(ranges):
        passes = -(-(-(-n // ranges)) // pass_w)   # ceil(ceil(n / r) / w)
        blocks = row_blocks * -(-n // (passes * pass_w))
        return -(-blocks // slots) * passes

    mine = -(-row_blocks * n_split // slots) * (split_w // pass_w)
    every = [cost(r) for r in range(1, max(1, n // pass_w) + 1)]
    assert mine == min(every)


@pytest.mark.parametrize("m,k,n,slots,dp,splits", [
    (5120, 5120, 2560, 132, 792, 16),   # lpt synthetic_dense, one block/SM
    (5120, 4480, 2560, 132, 792, 16),   # opt synthetic_dense k[0:4375]
    (5120, 5120, 2560, 264, 792, 20),   # two blocks an SM: 20 = 160 // 8
    (128, 128, 128, 132, 1, 1),         # journals: K too short to split
    (1920, 1024, 640, 10, 70, 2),       # tail 5 of 10 slots: 10 // 5
    (2048, 4096, 640, 15, 75, 3),       # tail 5 of 15 slots: 15 // 5
    (1920, 256, 640, 10, 75, 1),        # tail 5, but 8 K steps: one piece
    (1280, 4096, 640, 10, 50, 1),       # no tail
    (1920, 4096, 640, 15, 75, 1),       # no tail
    (2048, 4096, 640, 14, 80, 1),       # tail 10 of 14: whole
])
def test_gemm_plan_cases(m, k, n, slots, dp, splits):
    """The tiles computed whole and the pieces of each tail tile."""
    plan = tgemm.gemm_plan(m, k, n, slots)
    assert (plan.dp_tiles, plan.splits) == (dp, splits)


@pytest.mark.parametrize("tiles_m,tail,slots", [
    (10, 0, 16), (10, 4, 16), (10, 8, 16), (10, 9, 16), (3, 1, 16),
    (40, 8, 132), (40, 66, 132), (40, 67, 132),
])
def test_gemm_plan_splits_only_a_short_tail(tiles_m, tail, slots):
    """A tail is split exactly when it fills at most half of the last wave;
    its pieces then fit in one wave, and every tile outside it is whole."""
    n = 128 * 4
    tiles = slots * (tiles_m // 4) + tail
    m = 128 * -(-tiles // 4)
    plan = tgemm.gemm_plan(m, 8192, n, slots)
    assert plan.tiles == -(-tiles // 4) * 4
    t = plan.tiles % slots
    if t and 2 * t <= slots:
        assert plan.splits >= 2 and plan.tail == t
        assert plan.tail * plan.splits <= slots
    else:
        assert plan.splits == 1 and plan.dp_tiles == plan.tiles
    assert plan.blocks == plan.dp_tiles + plan.tail * plan.splits


@pytest.mark.parametrize("k", [256, 300, 1000, 4375, 5120])
@pytest.mark.parametrize("slots", [132, 264])
def test_gemm_plan_pieces_cover_k(k, slots):
    """The kernel's pieces of a split tile (steps [p·S/s, (p+1)·S/s)) cover
    every K step once, none empty and none shorter than the minimum."""
    plan = tgemm.gemm_plan(5120, k, 2560, slots)
    steps = -(-k // tgemm.GEMM_K_STEP)
    bounds = [p * steps // plan.splits for p in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == steps
    lengths = [b - a for a, b in zip(bounds, bounds[1:])]
    assert min(lengths) >= (tgemm.GEMM_MIN_PIECE_STEPS if plan.splits > 1
                            else 1)


@pytest.mark.parametrize("shape,dtype,offset,gran", [
    ((4, 300), torch.float32, 0, 4), ((4, 302), torch.float32, 0, 2),
    ((4, 301), torch.float32, 0, 1), ((4, 300), torch.bfloat16, 0, 4),
    ((4, 304), torch.bfloat16, 0, 8), ((4, 301), torch.bfloat16, 0, 1),
    ((4, 300), torch.float32, 1, 1), ((4, 304), torch.bfloat16, 2, 2),
])
def test_row_granule(shape, dtype, offset, gran):
    """Elements per async copy: the widest of 16, 8 and 4 bytes that every
    row start (the tensor's first element included) is aligned to, else 1."""
    base = torch.zeros(shape[0] * shape[1] + offset, dtype=dtype)
    t = base[offset:].view(shape)
    assert _build.row_granule(t) == gran


#: (m, k, n) of the inner sparse body's main-path launches, as
#: ``ops.spgemm_inner_operands`` pads them (lpt bibd_81_3 reduced, lpt
#: m3plates, lpt chem97ZtZ, lpt citeseer, speech n[975:1300], opt speech
#: k[0:1950] n[488:1300]), then ragged, tiny, skewed and K > 24576 ones.
INNER_SHAPES = [
    (640, 16384, 8320), (11008, 11008, 5504), (2560, 2560, 1280),
    (3328, 3328, 3712), (7808, 2688, 384), (7808, 2048, 896),
    (203, 300, 130), (1, 1, 1), (40, 300, 4096), (4096, 300, 40),
    (256, 30000, 130), (256, 50000, 130), (7, 24577, 33),
]


def ranges(n_split, split_w, n):
    """The fiber ranges ``[i·split_w, min(n, (i + 1)·split_w))`` of a row
    walk's splits."""
    return [(i * split_w, min(n, (i + 1) * split_w)) for i in range(n_split)]


@pytest.mark.parametrize("m,k,n", INNER_SHAPES)
@pytest.mark.parametrize("elem", ELEMS)
def test_inner_plan_fits_and_covers(m, k, n, elem):
    """The inner sparse plan: its rows (B's fibers, expanded) fit the
    block's 96 KB, every one of A's m walked fibers falls in exactly one
    range, none empty, every one of B's n fibers in exactly one row block,
    and the 1-D grid stays within CUDA's limit."""
    plan = tinner.inner_sparse_plan(m, k, n, elem, SMS)
    rows, window = tspmm.spmm_sparse_rows(n, k, elem)  # the mirrored rows
    assert (plan.rows, plan.window) == (rows, window)
    fibers, slots = tinner.INNER_WALK[plan.rows]
    assert plan.pass_w == tspmm.SPMM_THREADS * fibers
    assert fibers * plan.rows <= tspmm.SPMM_SUMS and slots >= 1
    assert plan.split_w % plan.pass_w == 0 or plan.n_split == 1
    assert plan.rows * plan.window * elem <= tspmm.SPMM_ROWS_BYTES
    assert 1 <= plan.window <= k
    assert plan.rows & (plan.rows - 1) == 0 and plan.rows <= tspmm.SPMM_SUMS
    seen = [0] * m
    for lo, hi in ranges(plan.n_split, plan.split_w, m):
        assert lo < hi
        for f in range(lo, hi):
            seen[f] += 1
    assert seen == [1] * m
    row_blocks = -(-n // plan.rows)
    assert (row_blocks - 1) * plan.rows < n <= row_blocks * plan.rows
    assert plan.blocks(n) == row_blocks * plan.n_split <= GRID_X_MAX
    # A block's first pass gives every thread a fiber where there are
    # enough of them (bibd_81_3: 640 walked fibers, 256 threads).
    assert min(plan.split_w, m) >= min(tspmm.SPMM_THREADS, m)


@pytest.mark.parametrize("m,k,n,rows,n_split", [
    (640, 16384, 8320, 1, 1),      # bibd_81_3: 8320 row blocks, one range
    (11008, 11008, 5504, 2, 1),    # m3plates: 2752 row blocks
    (3328, 3328, 3712, 4, 1),      # citeseer: 928 row blocks
    (2560, 2560, 1280, 8, 1),      # chem97ZtZ: 160 row blocks, >= 132 SMs
    (7808, 2688, 384, 8, 8),       # speech: 48 row blocks, split
    (7808, 2048, 896, 8, 8),       # opt speech: 112 row blocks, split
])
def test_inner_plan_main_path(m, k, n, rows, n_split):
    """The main-path launches' rows and splits on the H100's 132 SMs (f32):
    one B fiber a block at bibd_81_3, whose walked side (640 of A's rows)
    then takes one pass; splits where B's row blocks alone leave SMs idle,
    into as many ranges as keep the passes of the busiest SM fewest."""
    plan = tinner.inner_sparse_plan(m, k, n, 4, SMS)
    assert (plan.rows, plan.n_split) == (rows, n_split)
    if n_split > 1:   # the busiest SM's passes, against one range a block
        row_blocks = -(-n // rows)
        busiest = -(-plan.blocks(n) // SMS) * (plan.split_w // plan.pass_w)
        whole = -(-row_blocks // SMS) * -(-m // plan.pass_w)
        assert busiest < whole


@pytest.mark.parametrize("k,elem", [(30000, 4), (50000, 2), (24577, 4),
                                    (49153, 2)])
def test_inner_plan_k_windows(k, elem):
    """K too long for one expanded fiber: one fiber a block and windows of
    16-element multiples within 96 KB, which together cover K; each window
    reads the fiber's slots again, ``ceil(K / window)`` reads in all."""
    plan = tinner.inner_sparse_plan(256, k, 130, elem, SMS)
    assert plan.rows == 1 and plan.window < k
    assert plan.window % 16 == 0
    assert plan.window * elem <= tspmm.SPMM_ROWS_BYTES
    windows = -(-k // plan.window)
    assert (windows - 1) * plan.window < k <= windows * plan.window
    assert windows == 2


#: (m, n) of the Gustavson sparse body's launches: opt citeseer as
#: ``ops.spgemm_gustavson_operands`` pads it, then ragged and tiny ones and
#: M at and around the 1024-wide chunk.
GUSTAVSON_SHAPES = [
    (3328, 3712), (2100, 256), (1100, 133), (200, 130), (1, 1),
    (1024, 8), (1025, 9), (2048, 7), (11008, 5504), (640, 8320),
]


@pytest.mark.parametrize("m,n", GUSTAVSON_SHAPES)
def test_gustavson_grid_covers(m, n):
    """The Gustavson sparse grid: every one of B's n fibers (a row of Oᵀ)
    in exactly one block of 8 (a warp each), the M chunks of 1024 cover M
    once, none empty and only the last ragged, and both extents within
    CUDA's limits."""
    row_blocks, chunks = tgust.gustavson_sparse_grid(m, n)
    rows = tgust.GUSTAVSON_SPARSE_ROWS
    cols = tgust.GUSTAVSON_SPARSE_COLS
    assert (row_blocks - 1) * rows < n <= row_blocks * rows
    bounds = [(c * cols, min(m, (c + 1) * cols)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo == cols for lo, hi in bounds[:-1])
    assert row_blocks <= GRID_X_MAX and chunks <= GRID_Y_MAX


@pytest.mark.parametrize("cap,offset,dtype,vec", [
    (32, 0, torch.float32, 4), (300, 0, torch.float32, 4),
    (37, 0, torch.float32, 1), (32, 1, torch.float32, 1),
    (32, 0, torch.bfloat16, 4), (30, 0, torch.bfloat16, 1),
])
def test_fiber_vec(cap, offset, dtype, vec):
    """Slots a load of the inner sparse body's expansion: four where the
    capacity is a multiple of four and the ids and values start aligned
    (16 and 4 elements' bytes), else one."""
    n = 5
    ids = torch.zeros(n * cap + offset, dtype=torch.int32)[offset:]
    vals = torch.zeros(n * cap + offset, dtype=dtype)[offset:]
    e = tell.EllMatrix(vals.view(n, cap), ids.view(n, cap),
                       torch.zeros(n, dtype=torch.int32), (cap, n), 1)
    assert tinner.fiber_vec(e) == vec


#: (fibers, length, fiber stride, minor stride, element bytes, address) of
#: conversions: the Table I queue's largest (bibd_81_3's B by rows, its A
#: by rows and by columns, m3plates' B and speech's A by columns, gnmt's
#: B by columns) and small, ragged, strided and empty ones.
ELL_SHAPES = [
    (85000, 16000, 16000, 1, 4, 0), (3200, 85000, 85000, 1, 4, 0),
    (85000, 3200, 1, 85000, 4, 0), (5500, 11000, 1, 5500, 4, 0),
    (2600, 7700, 1, 2600, 4, 0), (36000, 1000, 1, 36000, 4, 0),
    (3200, 85000, 85000, 1, 2, 0), (7, 130, 130, 1, 2, 2),
    (1, 1_000_000, 1, 1, 4, 4), (1, 1_000_000, 0, 7, 2, 0),
    (40, 300_001, 1, 40, 4, 0), (9, 0, 0, 1, 4, 0), (1, 1, 1, 1, 4, 0),
    (50, 33, 66, 3, 4, 8), (333, 5000, 5004, 1, 4, 8),
]


@pytest.mark.parametrize("f,length,s_f,s_m,elem,ptr", ELL_SHAPES)
def test_ell_convert_plan_covers(f, length, s_f, s_m, elem, ptr):
    """Every plan of the conversion: the column body only for fibers side
    by side; a pack only where every fiber start and length is aligned to
    it; the grid within CUDA's limits."""
    plan = tec.ell_convert_plan(f, length, s_f, s_m, elem, ptr)
    if plan.layout == tec.COLS:
        assert s_f == 1 and s_m != 1 and f > 1
        assert -(-f // 32) <= GRID_X_MAX
    else:
        assert -(-f // tec.EC_WARPS) <= GRID_X_MAX
    vec = plan.vec_bytes
    assert vec % elem == 0 and vec <= 16
    if vec > elem:
        assert s_m == 1 and ptr % vec == 0 and length * elem % vec == 0
        assert f == 1 or s_f * elem % vec == 0


@pytest.mark.parametrize("f,length,s_f,s_m,elem,plan", [
    (85000, 16000, 16000, 1, 4, (tec.ROWS, 16)),   # bibd B rows
    (3200, 85000, 85000, 1, 4, (tec.ROWS, 16)),    # bibd A rows
    (85000, 3200, 1, 85000, 4, (tec.COLS, 4)),     # bibd A cols
    (36000, 1000, 1, 36000, 4, (tec.COLS, 4)),     # gnmt B cols
    (5500, 11000, 1, 5500, 4, (tec.COLS, 4)),      # m3plates B
    (2600, 7700, 1, 2600, 4, (tec.COLS, 4)),       # speech A
    (40, 300_001, 300_001, 1, 4, (tec.ROWS, 4)),
])
def test_ell_convert_plan_main_path(f, length, s_f, s_m, elem, plan):
    """The plans of the Table I queue's conversions: 16-byte packs along
    bibd's rows, the column body for every operand compressed by
    columns, and 4-byte loads where an odd row length breaks the pack."""
    got = tec.ell_convert_plan(f, length, s_f, s_m, elem, 0)
    assert (got.layout, got.vec_bytes) == plan
