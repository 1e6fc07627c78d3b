"""The walks of the inner-product and Gustavson sparse kernels
(``csrc/row_walk.cuh`` with B's fibers expanded into its rows, and
``csrc/row_merge.cuh`` with B's fibers read in place), in Python on the
CPU over the wrappers' plans and the kernels' index logic, held to the
port's plain versions and, where the operands are in the JAX package's
domain, to ``repro``'s ops in interpret mode, at ``tests/test_kernels.py``'s
tolerances (f32 ``rtol=atol=1e-4``, bf16 ``2e-2``).

The inner walk: the transpose pre-pass's live bounds and fiber ends from
A's lengths, each row block of B's fibers expanded over each K window
(zeroed, then each slot's value at its id), and each of A's fibers walked
in slot order against it. The Gustavson merge: each of B's fibers read 32
slots at a time, its live entries taken in order eight at a time, and
A's fiber runs in each M chunk found as the kernel finds them (no search
for a dense fiber, the whole fiber for a short or out-of-order one, the
binary search for a long ordered one), merged in rounds of 32 slots.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.formats import ell as tell
from repro_torch.kernels import spgemm_gustavson as tgust
from repro_torch.kernels import spgemm_inner as tinner
from repro_torch.kernels import spgemm_outer as touter
from repro_torch.kernels import spmm as tspmm
from test_torch_kernels import assert_close, ells, sparse
from test_torch_outer import fiber_kind, shuffle_live

WARP = 32


#: The H100's SMs, on which the inner plan splits A's fibers.
SMS = 132


def pad_inside(e: tell.EllMatrix) -> tell.EllMatrix:
    """``e`` with a PAD slot inside each fiber's live range: the live slot
    at half the live count swapped with the first PAD slot (fibers with
    fewer than two live slots, or at capacity, keep theirs)."""
    ids, vals = e.ids.clone(), e.vals.clone()
    for f in range(e.n_fibers):
        live = int((ids[f] >= 0).sum())
        if 2 <= live < e.cap:
            for t in (ids, vals):
                t[f, live // 2], t[f, live] = (t[f, live].clone(),
                                               t[f, live // 2].clone())
    return tell.EllMatrix(vals, ids, e.lens, e.shape, e.major_axis)


def with_bad_ids(e: tell.EllMatrix) -> tell.EllMatrix:
    """``e`` with the last live slot of every third fiber holding an id
    past its minor size: the sparse bodies drop it, as the plain versions
    do."""
    ids = e.ids.clone()
    for f in range(0, e.n_fibers, 3):
        live = int((ids[f] >= 0).sum())
        if live:
            ids[f, live - 1] = e.minor_size + 7
    return tell.EllMatrix(e.vals, ids, e.lens, e.shape, e.major_axis)


# ------------------------------------------------------------ inner walk
def walk_inner(a: tell.EllMatrix, b: tell.EllMatrix, bm: int,
               fc: int) -> np.ndarray:
    """The inner sparse kernel over :func:`spgemm_inner.inner_sparse_plan`:
    ``Oᵀ`` (N, M), returned as its (M, N) transpose."""
    (m, k), n = a.shape, b.shape[1]
    elem = a.vals.element_size()
    plan = tinner.inner_sparse_plan(m, k, n, elem, SMS)
    fibers, slots = tinner.INNER_WALK[plan.rows]
    assert fibers * plan.rows <= tspmm.SPMM_SUMS and slots >= 1
    a_ids, a_vals = a.ids.numpy(), a.vals.float().numpy()
    b_ids, b_vals = b.ids.numpy(), b.vals.float().numpy()
    lens = a.lens.numpy()
    # The transpose pre-pass: live bounds per block of bm fibers, ends.
    ends = np.zeros(m, np.int64)
    for f in range(m):
        b0 = f // bm * bm
        live = min(a.cap, -(-int(lens[b0:b0 + bm].max()) // fc) * fc)
        nz = np.nonzero(a_ids[f, :live] != -1)[0]
        ends[f] = nz[-1] + 1 if nz.size else 0
    out_t = np.zeros((n, m), np.float32)
    ranges = [(i * plan.split_w, min(m, (i + 1) * plan.split_w))
              for i in range(plan.n_split)]
    for r0 in range(0, n, plan.rows):
        rows = min(plan.rows, n - r0)
        for lo, hi in ranges:
            acc = np.zeros((hi - lo, plan.rows), np.float32)
            for k0 in range(0, k, plan.window):
                w = min(plan.window, k - k0)
                held = np.zeros((w, plan.rows), np.float32)  # k-major
                for r in range(rows):
                    for s in range(b.cap):
                        j = b_ids[r0 + r, s] - k0
                        if 0 <= j < w:
                            held[j, r] = b_vals[r0 + r, s]
                for f in range(lo, hi):
                    for c in range(ends[f]):       # slot order
                        j = a_ids[f, c] - k0
                        if 0 <= j < w:
                            acc[f - lo] += held[j] * np.float32(a_vals[f, c])
            out_t[r0:r0 + rows, lo:hi] = acc[:, :rows].T
    return out_t.T


INNER_CASES = ["ordered", "b_dense", "b_shuffled", "b_pad_inside",
               "bad_ids", "ragged", "k_windows", "a_block_empty"]


def inner_operands(case: str, dtype: str):
    """``(a, b, ja, ta, jb, tb, bm)``; ``ja``/``jb`` are None where the
    operands leave the JAX sparse body's domain."""
    rng = np.random.default_rng(7)
    m, k, n, da, db = 64, 200, 48, 0.05, 0.2
    if case == "b_dense":
        db = 1.0
    elif case == "ragged":
        m, k, n = 37, 123, 29
    elif case == "k_windows":
        m, k, n = 16, 150, 12
    a = sparse(rng, m, k, da)
    b = sparse(rng, k, n, db)
    if case == "a_block_empty":
        a[16:32] = 0
    ja, ta = ells(a, 0, dtype)
    jb, tb = ells(b, 1, dtype)
    if case == "b_shuffled":
        tb, jb = shuffle_live(tb, 3), None
    elif case == "b_pad_inside":
        tb, jb = pad_inside(tb), None
    elif case == "bad_ids":
        ta, tb, ja, jb = with_bad_ids(ta), with_bad_ids(tb), None, None
    bm = 16 if m % 16 == 0 else 1
    return a, b, ja, ta, jb, tb, bm


@pytest.mark.parametrize("case", INNER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inner_walk_rebuilds_the_product(monkeypatch, case, dtype):
    """The inner kernel's walk gives the plain version's product (and
    JAX's, in its domain); ``k_windows`` shrinks the rows' budget so that
    one of B's fibers is expanded in three K windows."""
    if case == "k_windows":
        monkeypatch.setattr(tspmm, "SPMM_ROWS_BYTES", 128)
    a, b, ja, ta, jb, tb, bm = inner_operands(case, dtype)
    plan = tinner.inner_sparse_plan(*ta.shape, tb.shape[1],
                                    ta.vals.element_size(), SMS)
    if case == "k_windows":
        assert plan.rows == 1 and -(-ta.shape[1] // plan.window) >= 3
    got = torch.from_numpy(walk_inner(ta, tb, bm, tinner.INNER_FIBER_CHUNK))
    assert_close(got, tinner.spgemm_inner_plain(ta, tb), dtype)
    if ja is not None and jb is not None:
        want = jops.spgemm_inner(ja, jb, method="sparse", interpret=True)
        assert_close(got, np.asarray(want, np.float32), dtype)


# ------------------------------------------------------- Gustavson merge
def fiber_run(ids, kind: int, x0: int, x1: int):
    """The slots ``[s0, s1)`` of fiber ``ids`` the merge reads for the
    chunk ``[x0, x1)``: a fiber of at most 32 slots whole, a dense fiber's
    without a search, a long ordered one's binary-searched, any other
    whole (ids tested)."""
    cap = len(ids)
    if cap <= WARP:                                  # one slot a lane
        return 0, cap
    if kind >= 0:
        return min(x0, kind), min(x1, kind)
    if kind == -1 and cap > 64:                     # OS_SCAN_CAP
        return touter.fiber_window(ids, x0, x1)
    return 0, cap


def walk_gustavson(a: tell.EllMatrix, b: tell.EllMatrix) -> np.ndarray:
    """The Gustavson sparse kernel over
    :func:`spgemm_gustavson.gustavson_sparse_grid`: ``Oᵀ`` (N, M), returned
    as its (M, N) transpose."""
    (m, k), n = a.shape, b.shape[1]
    rows_blocks, chunks = tgust.gustavson_sparse_grid(m, n)
    cols = tgust.GUSTAVSON_SPARSE_COLS
    a_ids, a_vals = a.ids.numpy(), a.vals.float().numpy()
    b_ids, b_vals = b.ids.numpy(), b.vals.float().numpy()
    kinds = [fiber_kind(f, m) for f in a_ids]
    out_t = np.zeros((n, m), np.float32)
    for row in range(min(n, rows_blocks * tgust.GUSTAVSON_SPARSE_ROWS)):
        for ch in range(chunks):
            m0, width = ch * cols, min(cols, m - ch * cols)
            acc = np.zeros(width, np.float32)
            for g in range(0, b.cap, WARP):         # 32 slots at a time
                live = [s for s in range(g, min(g + WARP, b.cap))
                        if 0 <= b_ids[row, s] < k]
                for e0 in range(0, len(live), 8):   # kBatch entries
                    batch = [(b_ids[row, s], np.float32(b_vals[row, s]))
                             for s in live[e0:e0 + 8]]
                    runs = [fiber_run(a_ids[kk], kinds[kk], m0, m0 + width)
                            for kk, _ in batch]
                    most = max(s1 - s0 for s0, s1 in runs)
                    for off in range(0, most, WARP):  # rounds of 32 slots
                        for (kk, v), (s0, s1) in zip(batch, runs):
                            for s in range(s0 + off, min(s1, s0 + off + WARP)):
                                c = a_ids[kk, s] - m0
                                if 0 <= c < width:
                                    acc[c] += v * np.float32(a_vals[kk, s])
            out_t[row, m0:m0 + width] = acc
    return out_t.T


GUSTAVSON_CASES = ["a_short", "a_long", "a_dense", "a_shuffled",
                   "b_pad_inside", "bad_ids", "m_chunks", "all_zero_a"]


def gustavson_operands(case: str, dtype: str):
    """``(a, b, ja, ta, jb, tb)``; ``ja``/``jb`` are None where the
    operands leave the JAX sparse body's domain."""
    rng = np.random.default_rng(9)
    m, k, n, da, db = 120, 90, 40, 0.1, 0.1
    if case == "a_long":
        m, da = 300, 0.3          # fibers of about 90 slots: searched
    elif case == "a_dense":
        da = 1.0
    elif case == "m_chunks":
        m, da = 1100, 0.02        # a whole chunk of 1024 and one of 76
    a = sparse(rng, m, k, da)
    b = sparse(rng, k, n, db)
    if case == "a_dense":
        a[50:, 7] = 0             # a dense fiber cut short
    elif case == "all_zero_a":
        a[:] = 0
    ja, ta = ells(a, 1, dtype)
    jb, tb = ells(b, 1, dtype)
    if case == "a_shuffled":
        ta, ja = shuffle_live(ta, 4), None
    elif case == "b_pad_inside":
        tb, jb = pad_inside(shuffle_live(tb, 5)), None
    elif case == "bad_ids":
        ta, tb, ja, jb = with_bad_ids(ta), with_bad_ids(tb), None, None
    return a, b, ja, ta, jb, tb


@pytest.mark.parametrize("case", GUSTAVSON_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gustavson_merge_rebuilds_the_product(case, dtype):
    """The Gustavson kernel's merge gives the plain version's product (and
    JAX's, in its domain), through every way it finds A's runs."""
    a, b, ja, ta, jb, tb = gustavson_operands(case, dtype)
    kinds = {fiber_kind(f, ta.shape[0]) for f in ta.ids.numpy()}
    if case == "a_dense":
        assert all(kd >= 0 for kd in kinds)
    elif case == "a_long":
        assert kinds == {-1} and ta.cap > 64
    elif case == "a_shuffled":
        assert -2 in kinds
    got = torch.from_numpy(walk_gustavson(ta, tb))
    want = tgust.spgemm_gustavson_plain(ta, tb)
    assert_close(got, want, dtype)
    if case == "all_zero_a":
        assert not got.any()
    if ja is not None and jb is not None:
        want = jops.spgemm_gustavson(ja, jb, method="sparse", interpret=True)
        assert_close(got, np.asarray(want, np.float32), dtype)
