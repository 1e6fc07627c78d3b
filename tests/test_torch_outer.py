"""The index logic of the port's outer-product SpGEMM kernels
(``repro_torch.kernels.spgemm_outer``), on the CPU: the reference body's
live-K lists and A slot ranges per M tile, the binary search that finds a
B fiber's run in an N window (in Python, as the kernels do it), and the
sparse body's row-order transposition of A, each against a numpy loop.
Then both kernels' walks, in Python over those outputs, rebuild the
product and are held against the JAX package's ``spgemm_outer`` in
interpret mode, at ``tests/test_kernels.py``'s tolerances (f32
``rtol=atol=1e-4``, bf16 ``2e-2``).

The same for the chunked rank-update kernel of the SpMM, inner and
Gustavson reference bodies (``csrc/chunk_update.cuh``): its live lists
(SpMM's live K chunks per N tile, inner's live k per M tile), a fiber's
merge over a chunk from its cursor, and the whole walk, in Python, held
to each op's plain version; and the reference wrappers' pre-passes make
no ``torch.bincount`` call (it reads its input's range back to the host).
"""
import numpy as np
import pytest
import torch

import contextlib
import ctypes

from repro.kernels import ops as jops
from repro_torch.formats import ell as tell
from repro_torch.kernels import _build
from repro_torch.kernels import spgemm_gustavson as tgust
from repro_torch.kernels import spgemm_inner as tinner
from repro_torch.kernels import spgemm_outer as touter
from repro_torch.kernels import spmm as tspmm
from test_torch_kernels import assert_close, ells, sparse

TILE = touter.OUTER_REFERENCE_TILE_M
CHUNK = touter.OUTER_REFERENCE_CHUNK


def shuffle_live(e: tell.EllMatrix, seed: int) -> tell.EllMatrix:
    """``e`` with each fiber's live slots in random order (PAD slots stay
    last)."""
    rng = np.random.default_rng(seed)
    ids, vals = e.ids.numpy().copy(), e.vals.clone()
    for f in range(e.n_fibers):
        live = int((ids[f] >= 0).sum())
        perm = np.concatenate([rng.permutation(live),
                               np.arange(live, e.cap)])
        ids[f] = ids[f][perm]
        vals[f] = vals[f][torch.from_numpy(perm)]
    return tell.EllMatrix(vals, torch.from_numpy(ids), e.lens, e.shape,
                          e.major_axis)


def case_operands(case: str):
    """Dense numpy ``(a, b)`` for one edge case of the outer kernels."""
    rng = np.random.default_rng(11)
    m, k, n = 300, 260, 320
    a = sparse(rng, m, k, 0.04)
    b = sparse(rng, k, n, 0.06)
    if case == "empty_m_window":
        a[128:256, :] = 0
    elif case == "empty_n_window":
        b[:, 128:256] = 0
    elif case == "at_cap":
        # A's fiber 5 and B's fiber 7 are the fullest: each lands exactly
        # at its capacity.
        a[:, 5] = 0
        a[np.arange(0, m, 7), 5] = -2.0
        b[7, :] = 0
        b[7, np.arange(0, n, 5)] = 1.5
    elif case == "all_zero_a":
        a[:] = 0
    elif case == "live_k_37":
        # M tile 0 holds entries in exactly 37 fibers: one full chunk of
        # 32 and a ragged one of 5.
        a[:128, :] = 0
        a[np.arange(37) % 128, np.arange(0, 37 * 7, 7)] = 0.5
    elif case == "dense_a_sparse_b":
        m, k, n = 150, 100, 200
        a = sparse(rng, m, k, 1.0)
        b = sparse(rng, k, n, 0.01)
    elif case == "ragged":
        m, k, n = 200, 70, 130
        a = sparse(rng, m, k, 0.1)
        b = sparse(rng, k, n, 0.1)
    elif case == "dense_b":
        # Every B fiber's ids are its slots (no search needed), a few
        # fibers empty or cut short.
        b = sparse(rng, k, n, 1.0)
        b[3, :] = 0
        b[9, 200:] = 0
    return a, b


CASES = ["ordered", "shuffled", "empty_m_window", "empty_n_window",
         "at_cap", "all_zero_a", "live_k_37", "dense_a_sparse_b", "ragged",
         "dense_b"]


def torch_operands(case: str, dtype: str = "float32"):
    """The case's ELL operands, both packages: A as K fibers (ids -> M), B
    as K fibers (ids -> N), each at its fullest fiber's capacity (at least
    one). ``shuffled`` shuffles the live slots of both port operands."""
    a, b = case_operands(case)
    ja, ta = ells(a, 1, dtype)
    jb, tb = ells(b, 0, dtype)
    if case == "shuffled":
        ta, tb = shuffle_live(ta, 1), shuffle_live(tb, 2)
        assert not tinner._ordered(ta).all()
        assert not tinner._ordered(tb).all()
    if case == "dense_b":               # PAD slots after the dense ids
        tb = tell.pad_capacity(tb, tb.cap + 8)
    return a, b, ja, ta, jb, tb


def fiber_kind(ids: np.ndarray, minor: int) -> int:
    """``fiber_scan_kernel``'s verdict on one fiber: -2 out of order
    (scanned whole), the live count L when the ids are the slots
    ``0..L-1`` (no search), else -1 (binary-searched)."""
    key = np.where(ids >= 0, ids, minor)
    if not (((ids >= -1) & (ids < minor)).all() and (np.diff(key) >= 0).all()):
        return -2
    live = int((ids >= 0).sum())
    return live if (ids[:live] == np.arange(live)).all() else -1


def b_window(ids: np.ndarray, kind: int, x0: int, x1: int):
    """The slots of B's window ``[x0, x1)`` as the kernels find them."""
    if kind >= 0:
        return min(x0, kind), min(x1, kind)
    return touter.fiber_window(ids, x0, x1)


# ------------------------------------------------------- numpy oracles
def live_lists_loop(ids: np.ndarray, m: int, tile: int):
    """Per M tile, the k whose fiber holds an id in the tile, ascending."""
    n_tiles = -(-m // tile)
    out = [[] for _ in range(n_tiles)]
    for k in range(ids.shape[0]):
        tiles = {int(i) // tile for i in ids[k] if 0 <= i < m}
        for t in sorted(tiles):
            out[t].append(k)
    return out


@pytest.mark.parametrize("case", CASES)
def test_live_k_lists_match_loop(case):
    _, _, _, ta, _, _ = torch_operands(case)
    m, k = ta.shape
    live_k, live_n, a_off = touter.live_k_lists(ta)
    ids = ta.ids.numpy()
    want = live_lists_loop(ids, m, TILE)
    n_tiles = len(want)
    assert live_k.shape == (n_tiles, k + 1) and live_k.dtype == torch.int32
    assert a_off.shape == (k, n_tiles + 1) and a_off.dtype == torch.int32
    np.testing.assert_array_equal(live_n.numpy(), [len(w) for w in want])
    for t, w in enumerate(want):
        np.testing.assert_array_equal(live_k[t, :len(w)].numpy(), w)
    if case == "live_k_37":
        assert int(live_n[0]) == 37 and 37 % CHUNK
    if case == "all_zero_a":
        assert int(live_n.sum()) == 0
    if case == "empty_m_window":
        assert int(live_n[1]) == 0
    if case == "at_cap":
        assert int(ta.lens[5]) == ta.cap
    # Slot ranges of the ordered fibers: exactly the slots in each tile.
    ordered = tinner._ordered(ta).numpy()
    for f in np.flatnonzero(ordered):
        for t in range(n_tiles):
            slots = [s for s, i in enumerate(ids[f])
                     if t * TILE <= i < min(m, (t + 1) * TILE)]
            lo, hi = int(a_off[f, t]), int(a_off[f, t + 1])
            assert list(range(lo, hi)) == slots, (f, t)


def ordered_fiber(rng, cap: int, live: int, minor: int) -> np.ndarray:
    ids = np.full(cap, tell.PAD_ID, np.int32)
    ids[:live] = np.sort(rng.choice(minor, size=live, replace=False))
    return ids


@pytest.mark.parametrize("cap,live", [
    (0, 0), (1, 0), (1, 1), (5, 3), (31, 31), (32, 32), (32, 7), (33, 33),
    (64, 40), (200, 200), (1025, 1000), (5000, 1234), (5000, 5000)])
def test_warp_lower_bound_matches_searchsorted(cap, live):
    """The kernels' 32-ary search finds numpy's ``searchsorted`` position
    for every target, in ranges of every width (0, under, at and over a
    warp, several steps deep), PAD slots counted as +inf, in sparse and
    dense fibers."""
    rng = np.random.default_rng(cap * 7 + live)
    minor = max(2 * live, 8) if live < cap or live < 64 else live
    ids = ordered_fiber(rng, cap, live, minor)
    key = np.where(ids >= 0, ids, np.iinfo(np.int32).max)
    for x in sorted(set(rng.integers(-1, minor + 2, size=12).tolist()
                        + [0, minor])):
        want = int(np.searchsorted(key, x, side="left"))
        assert touter.warp_lower_bound(ids, 0, cap, x) == want, x
    for lo, hi in [(0, cap // 2), (cap // 3, cap), (cap // 2, cap // 2)]:
        x = int(rng.integers(0, minor))
        want = lo + int(np.searchsorted(key[lo:hi], x, side="left"))
        assert touter.warp_lower_bound(ids, lo, hi, x) == want


@pytest.mark.parametrize("window", [(0, 128), (128, 256), (256, 320),
                                    (0, 1024), (300, 1324)])
@pytest.mark.parametrize("case", ["ordered", "empty_n_window", "at_cap",
                                  "dense_a_sparse_b", "dense_b"])
def test_fiber_window_matches_loop(case, window):
    """A B fiber's run in an N window, as the kernels find it: the slots
    whose ids lie in the window, and no others, by the binary search and,
    for a fiber whose ids are its slots, without one."""
    _, _, _, _, _, tb = torch_operands(case)
    x0, x1 = window
    ids = tb.ids.numpy()
    kinds = [fiber_kind(f, tb.minor_size) for f in ids]
    for f in range(tb.n_fibers):
        want = [s for s, i in enumerate(ids[f]) if x0 <= i < x1]
        assert list(range(*touter.fiber_window(ids[f], x0, x1))) == want, f
        assert list(range(*b_window(ids[f], kinds[f], x0, x1))) == want, f
        if case == "empty_n_window" and (x0, x1) == (128, 256):
            assert not want
    if case == "dense_b":
        assert kinds[3] == 0 and kinds[9] == 200
        assert sum(kd >= 0 for kd in kinds) == tb.n_fibers
    else:
        assert -1 in kinds


@pytest.mark.parametrize("case", CASES)
def test_a_row_order_matches_loop(case):
    _, _, _, ta, _, _ = torch_operands(case)
    m = ta.shape[0]
    row_ptr, order = touter.a_row_order(ta)
    assert row_ptr.shape == (m + 1,) and row_ptr.dtype == torch.int32
    assert order.shape == (ta.n_fibers * ta.cap,)
    ids = ta.ids.numpy()
    for r in range(m):
        want = [k * ta.cap + s for k in range(ta.n_fibers)
                for s in range(ta.cap) if ids[k, s] == r]
        e0, e1 = int(row_ptr[r]), int(row_ptr[r + 1])
        assert order[e0:e1].tolist() == want, r
    assert int(row_ptr[m]) - int(row_ptr[0]) == int((ta.ids >= 0).sum())


# ------------------------------------------- the kernels' walks, in Python
def expand(ids, vals, ordered, s0, s1, lo, width, row) -> bool:
    """``expand_window``: an ordered fiber's run, untested (asserting that
    the run holds only ids in the window), or a tested scan."""
    wrote = False
    if ordered:
        for s in range(s0, s1):
            assert 0 <= ids[s] - lo < width
            row[ids[s] - lo] = vals[s]
            wrote = True
    else:
        for s, i in enumerate(ids):
            if 0 <= i - lo < width:
                row[i - lo] = vals[s]
                wrote = True
    return wrote


def walk_reference(a: tell.EllMatrix, b: tell.EllMatrix) -> np.ndarray:
    """The reference kernel: per (M tile, N tile), the tile's live-K list in
    chunks; per chunk A's and B's slots into expansion tiles, and a rank
    update unless B has no entry in the chunk."""
    (m, _), n = a.shape, b.shape[1]
    live_k, live_n, a_off = (x.numpy() for x in touter.live_k_lists(a))
    a_ord = tinner._ordered(a).numpy()
    a_ids, a_vals = a.ids.numpy(), a.vals.float().numpy()
    b_ids, b_vals = b.ids.numpy(), b.vals.float().numpy()
    b_kind = [fiber_kind(f, n) for f in b_ids]
    out = np.zeros((m, n), np.float32)
    for t in range(len(live_n)):
        m0, ks = t * TILE, live_k[t, :live_n[t]]
        for n0 in range(0, n, TILE):
            acc = np.zeros((TILE, TILE), np.float32)
            for c0 in range(0, len(ks), CHUNK):
                ea = np.zeros((CHUNK, TILE), np.float32)
                eb = np.zeros((CHUNK, TILE), np.float32)
                hit = False
                for kk, k in enumerate(ks[c0:c0 + CHUNK]):
                    expand(a_ids[k], a_vals[k], a_ord[k], a_off[k, t],
                           a_off[k, t + 1], m0, TILE, ea[kk])
                    ordered = b_kind[k] != -2
                    s0, s1 = (b_window(b_ids[k], b_kind[k], n0, n0 + TILE)
                              if ordered else (0, 0))
                    hit |= expand(b_ids[k], b_vals[k], ordered, s0, s1, n0,
                                  TILE, eb[kk])
                if hit:
                    acc += ea.T @ eb
            rows, cols = min(TILE, m - m0), min(TILE, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


def walk_sparse(a: tell.EllMatrix, b: tell.EllMatrix) -> np.ndarray:
    """The sparse kernel: per output row and column chunk, the row's
    entries in order, each adding ``v·B[k, n]`` over B fiber k's run in
    the chunk."""
    (m, _), n = a.shape, b.shape[1]
    cols = touter.OUTER_SPARSE_COLS
    row_ptr, order = (x.numpy() for x in touter.a_row_order(a))
    a_vals = a.vals.float().numpy().reshape(-1)
    b_ids, b_vals = b.ids.numpy(), b.vals.float().numpy()
    b_kind = [fiber_kind(f, n) for f in b_ids]
    runs = {}
    out = np.zeros((m, n), np.float32)
    for r in range(m):
        for n0 in range(0, n, cols):
            width = min(cols, n - n0)
            acc = np.zeros(width, np.float32)
            for e in range(row_ptr[r], row_ptr[r + 1]):
                k, v = order[e] // a.cap, a_vals[order[e]]
                if b_kind[k] != -2:
                    if (k, n0) not in runs:
                        runs[k, n0] = b_window(b_ids[k], b_kind[k], n0,
                                               n0 + width)
                    slots = range(*runs[k, n0])
                else:
                    slots = [s for s, i in enumerate(b_ids[k])
                             if 0 <= i - n0 < width]
                for s in slots:
                    assert 0 <= b_ids[k, s] - n0 < width
                    acc[b_ids[k, s] - n0] += np.float32(v * b_vals[k, s])
            out[r, n0:n0 + width] = acc
    return out


# Every case in f32; in bf16 the three whose values differ most (the index
# logic does not depend on the dtype).
WALKS = ([(case, "float32") for case in CASES]
         + [(case, "bfloat16") for case in ("ordered", "shuffled",
                                            "dense_a_sparse_b")])


@pytest.mark.parametrize("case,dtype", WALKS)
def test_kernel_walks_rebuild_the_product(case, dtype):
    """Both kernels' walks over the pre-passes' outputs give the JAX
    package's product (interpret mode), and an all-zero A gives zeros."""
    a, b, ja, ta, jb, tb = torch_operands(case, dtype)
    want = np.asarray(jops.spgemm_outer(ja, jb, interpret=True), np.float32)
    for walk in (walk_reference, walk_sparse):
        got = torch.from_numpy(walk(ta, tb))
        assert got.shape == (a.shape[0], b.shape[1])
        assert_close(got, want, dtype)
        if case == "all_zero_a":
            assert not got.any()


# ------------------------ the chunked rank-update kernel (chunk_update.cuh)
CU = tspmm.REFERENCE_TILE
KC = tspmm.REFERENCE_CHUNK
INT_MAX = int(np.iinfo(np.int32).max)


def chunk_case(case: str):
    """Dense numpy ``(a, b)`` for one case of the chunked kernel, and the
    fiber (``"middle"`` or ``"last"``) that gets an id out of range."""
    rng = np.random.default_rng(21)
    m, k, n = 200, 150, 180
    da, db = 0.3, 0.3
    if case == "sparse_a":          # scattered live-k lists (inner, Gustavson)
        da = 0.02
    elif case == "dense_b":         # every B fiber's ids are its slots
        db = 1.0
    elif case == "k_ragged":        # K not a multiple of the chunk
        k = 77
    elif case == "jump":            # long B fibers, far-apart live k
        k, da, db = 600, 0.004, 0.6
    a = sparse(rng, m, k, da)
    b = sparse(rng, k, n, db)
    if case == "empty_tiles":       # M tile 1 and N tile 1 hold nothing
        a[128:, :] = 0
        b[:, 128:] = 0
    if case == "dense_b":
        b[:, 7] = 0                 # an empty fiber
        b[100:, 9] = 0              # a fiber cut short
    return a, b


CHUNK_CASES = ["random", "sparse_a", "empty_tiles", "shuffled", "dense_b",
               "k_ragged", "jump", "out_of_range_middle", "out_of_range_last"]


def with_bad_id(e: tell.EllMatrix, where: str) -> tell.EllMatrix:
    """``e`` with the last live slot of its middle or last fiber holding an
    id at ``(n_tiles + 1)·128`` past its minor size (order kept)."""
    f = e.n_fibers // 2 if where == "middle" else e.n_fibers - 1
    ids = e.ids.clone()
    live = int((ids[f] >= 0).sum())
    assert live > 0
    ids[f, live - 1] = (-(-e.minor_size // CU) + 1) * CU + 5
    return tell.EllMatrix(e.vals, ids, e.lens, e.shape, e.major_axis)


def chunk_operands(case: str, op: str):
    """The port operands of ``op`` ("spmm", "inner", "gustavson") for a
    case, each compressed at its fullest fiber's capacity."""
    a, b = chunk_case(case)
    tb = ells(b, 1, "float32")[1]
    ta = (torch.from_numpy(a) if op == "spmm"
          else ells(a, 0 if op == "inner" else 1, "float32")[1])
    if case == "shuffled":
        tb = shuffle_live(tb, 3)
        if op != "spmm":
            ta = shuffle_live(ta, 4)
    if case.startswith("out_of_range"):
        where = case.rsplit("_", 1)[1]
        tb = with_bad_id(tb, where)
        if op != "spmm":
            ta = with_bad_id(ta, where)
    return ta, tb


def chunk_ks(lists, counts, t: int, c: int, k: int, dense_rows: bool):
    """``make_chunk``: the chunk's k, ascending."""
    if dense_rows:
        k0 = int(lists[t, c]) * KC
        return list(range(k0, min(k0 + KC, k)))
    return [int(x) for x in lists[t, c * KC:min(int(counts[t]), c * KC + KC)]]


def chunk_pos(ks, key: int) -> int:
    """``chunk_pos``: ``key - k0`` for contiguous k, else the warp-shuffle
    binary search over the 32 lanes' k (``INT_MAX`` past the chunk)."""
    kn = len(ks)
    if ks[-1] - ks[0] == kn - 1:
        return key - ks[0] if ks[0] <= key <= ks[-1] else -1
    lanes = ks + [INT_MAX] * (KC - kn)
    pos = 0
    for step in (16, 8, 4, 2, 1):
        if lanes[pos + step] <= key:
            pos += step
    return pos if lanes[pos] == key and pos < kn else -1


def fiber_key(ids, s: int) -> int:
    return INT_MAX if s >= len(ids) or ids[s] < 0 else int(ids[s])


def aligned_chunk(ks) -> int:
    """``make_chunk``'s ``q``: the aligned 32-wide K chunk a contiguous
    chunk starting at a multiple of 32 is, else -1."""
    contiguous = ks[-1] - ks[0] == len(ks) - 1
    return ks[0] // KC if contiguous and ks[0] % KC == 0 else -1


def merge_fiber(ids, vals, kind: int, cur: int, ks, col, starts):
    """``load_batch``/``store_batch`` for one fiber over a chunk into
    ``col`` (length 32, chunk positions): a dense fiber at slot k; an
    ordered one read exactly over its run in an aligned chunk (``starts``,
    the fiber's column of ``fiber_chunk_starts``), else merged from its
    cursor (a 32-slot read per round, the binary search when all 32 lie
    before the chunk); any other scanned whole. Returns the new cursor and
    whether an entry was written."""
    cap, wrote = len(ids), False
    if kind >= 0:
        for j, k in enumerate(ks):
            col[j] = vals[k] if k < kind else 0.0
            wrote |= k < kind
        return cur, wrote
    col[:] = 0.0
    q = aligned_chunk(ks)
    if kind == -1 and q >= 0:
        for s in range(starts[q], starts[q + 1]):
            assert q * KC <= ids[s] < (q + 1) * KC
            if ids[s] <= ks[-1]:
                col[ids[s] - ks[0]], wrote = vals[s], True
        return int(starts[q + 1]), wrote
    if kind == -2:
        for s in range(cap):
            p = chunk_pos(ks, fiber_key(ids, s))
            if p >= 0:
                col[p], wrote = vals[s], True
        return cur, wrote
    s0 = cur
    while True:
        keys = [fiber_key(ids, s0 + lane) for lane in range(32)]
        if all(key < ks[0] for key in keys):
            s0 = touter.warp_lower_bound(ids, s0 + 32, cap, ks[0])
            continue
        for lane, key in enumerate(keys):
            p = chunk_pos(ks, key)
            if p >= 0:
                col[p], wrote = vals[s0 + lane], True
        past = [lane for lane, key in enumerate(keys) if key > ks[-1]]
        if past:
            return s0 + past[0], wrote
        s0 += 32


def walk_chunks(a, b: tell.EllMatrix) -> np.ndarray:
    """The chunked rank-update kernel over its pre-passes' outputs: per
    128 x 128 tile, the tile's live list in chunks of 32; per chunk A's
    and B's entries at the chunk's k into K-major tiles, then a rank
    update unless no B fiber of the tile holds an entry. ``a`` is a dense
    tensor (SpMM), row fibers (inner) or K fibers (Gustavson)."""
    dense_rows = isinstance(a, torch.Tensor)
    m, k = a.shape
    n = b.shape[1]
    b_ids, b_vals = b.ids.numpy(), b.vals.float().numpy()
    b_kind = [fiber_kind(f, k) for f in b_ids]
    b_runs = touter.fiber_chunk_starts(b, KC).numpy().T
    if dense_rows:
        lists, counts = (x.numpy() for x in tspmm.live_chunks(b))
        av = a.float().numpy()
    else:
        a_ids, a_vals = a.ids.numpy(), a.vals.float().numpy()
        if a.major_axis == 0:
            lists, counts = (x.numpy() for x in tinner.live_k_rows(a))
            a_kind = [fiber_kind(f, k) for f in a_ids]
            a_runs = touter.fiber_chunk_starts(a, KC).numpy().T
        else:
            lists, counts, a_off = (x.numpy()
                                    for x in touter.live_k_lists(a, CU))
            a_kind = [fiber_kind(f, m) for f in a_ids]
    out = np.zeros((m, n), np.float32)
    for m0 in range(0, m, CU):
        rows = min(CU, m - m0)
        for n0 in range(0, n, CU):
            cols = min(CU, n - n0)
            t = n0 // CU if dense_rows else m0 // CU
            count = int(counts[t])
            chunks = count if dense_rows else -(-count // KC)
            cur_a, cur_b = [0] * CU, [0] * CU
            acc = np.zeros((CU, CU), np.float32)
            for c in range(chunks):
                ks = chunk_ks(lists, counts, t, c, k, dense_rows)
                ea = np.zeros((KC, CU), np.float32)
                eb = np.zeros((KC, CU), np.float32)
                if dense_rows:
                    ea[:len(ks), :rows] = av[m0:m0 + rows, ks].T
                elif a.major_axis == 0:
                    for i in range(rows):
                        f = m0 + i
                        cur_a[i], _ = merge_fiber(a_ids[f], a_vals[f],
                                                  a_kind[f], cur_a[i], ks,
                                                  ea[:, i], a_runs[f])
                else:
                    for j, kk in enumerate(ks):
                        ordered = a_kind[kk] != -2
                        expand(a_ids[kk], a_vals[kk], ordered,
                               a_off[kk, t], a_off[kk, t + 1], m0, CU, ea[j])
                hit = False
                for i in range(cols):
                    f = n0 + i
                    cur_b[i], wrote = merge_fiber(b_ids[f], b_vals[f],
                                                  b_kind[f], cur_b[i], ks,
                                                  eb[:, i], b_runs[f])
                    hit |= wrote
                if hit:
                    acc += ea[:len(ks)].T @ eb[:len(ks)]
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


PLAIN = {"spmm": tspmm.spmm_plain, "inner": tinner.spgemm_inner_plain,
         "gustavson": tgust.spgemm_gustavson_plain}


@pytest.mark.parametrize("op", ["spmm", "inner", "gustavson"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_walk_rebuilds_the_product(case, op):
    """The chunked kernel's walk, in Python over its pre-passes, gives the
    op's plain version (itself held to the JAX package's reference bodies),
    out-of-range ids dropped."""
    ta, tb = chunk_operands(case, op)
    want = PLAIN[op](ta, tb)
    got = torch.from_numpy(walk_chunks(ta, tb))
    assert got.shape == want.shape
    assert_close(got, want, "float32")
    if case == "empty_tiles":
        assert not got[128:].any() and not got[:, 128:].any()


def live_groups_loop(ids: np.ndarray, minor: int, tile: int, group: int):
    """Per tile of ``tile`` fibers, the sorted ``id // group`` of ids in
    ``[0, minor)``."""
    return [sorted({int(i) // group for f in range(t, min(t + tile,
                                                          len(ids)))
                    for i in ids[f] if 0 <= i < minor})
            for t in range(0, len(ids), tile)]


@pytest.mark.parametrize("case", CHUNK_CASES + ["all_zero"])
def test_live_k_rows_match_loop(case):
    """Inner's per-M-tile live-k lists: the union of the tile's row fibers'
    ids in ``[0, K)``, ascending."""
    if case == "all_zero":
        a = tell.dense_to_ell(torch.zeros(200, 150), 0, 8)
    else:
        a = chunk_operands(case, "inner")[0]
    live_k, live_n = tinner.live_k_rows(a)
    want = live_groups_loop(a.ids.numpy(), a.minor_size, CU, 1)
    assert live_k.shape == (len(want), a.minor_size + 1)
    assert live_k.dtype == live_n.dtype == torch.int32
    np.testing.assert_array_equal(live_n.numpy(), [len(w) for w in want])
    for t, w in enumerate(want):
        np.testing.assert_array_equal(live_k[t, :len(w)].numpy(), w)
    if case == "empty_tiles":
        assert int(live_n[1]) == 0
    if case in ("random", "k_ragged"):     # every k live
        assert (live_n.numpy() == a.minor_size).all()
    if case == "sparse_a":
        assert 0 < int(live_n[0]) < a.minor_size and int(live_n[0]) % KC


@pytest.mark.parametrize("case", CHUNK_CASES + ["all_zero"])
def test_live_chunks_match_loop(case):
    """SpMM's per-N-tile live chunks: the 32-wide K chunks some fiber of
    the tile holds, ascending."""
    if case == "all_zero":
        b = tell.dense_to_ell(torch.zeros(150, 180), 1, 8)
    else:
        b = chunk_operands(case, "spmm")[1]
    chunks, counts = tspmm.live_chunks(b)
    want = live_groups_loop(b.ids.numpy(), b.minor_size, CU, KC)
    assert chunks.shape == (len(want), -(-b.minor_size // KC) + 1)
    np.testing.assert_array_equal(counts.numpy(), [len(w) for w in want])
    for t, w in enumerate(want):
        np.testing.assert_array_equal(chunks[t, :len(w)].numpy(), w)
    if case == "empty_tiles":
        assert int(counts[1]) == 0


@pytest.mark.parametrize("lists", ["contiguous", "aligned_gaps",
                                   "scattered", "far", "jump"])
@pytest.mark.parametrize("case", ["random", "shuffled", "dense_b", "jump",
                                  "out_of_range_last"])
def test_fiber_merge_matches_loop(case, lists):
    """Each B fiber's entries at a chunk's k, as the kernel finds them
    over a walk of chunks (contiguous or aligned chunks with gaps between
    them, read as exact runs; scattered, or after a far gap, which the
    binary search jumps, merged from the cursor): exactly the slots
    whose ids the chunk holds, at their chunk positions; an ordered fiber's
    cursor never moves back and never passes an entry still to come."""
    tb = chunk_operands(case, "spmm")[1]
    k = tb.minor_size
    rng = np.random.default_rng(5)
    if lists == "contiguous":
        walk = list(range(k))
    elif lists == "aligned_gaps":   # every other aligned chunk, as SpMM's
        walk = [x for x in range(k) if x // KC % 2 == 0]
    elif lists == "scattered":
        walk = sorted(rng.choice(k, size=k // 3, replace=False).tolist())
    elif lists == "far":
        walk = sorted(rng.choice(k, size=min(40, k), replace=False).tolist())
    else:   # an aligned chunk, then an unaligned one far past it
        walk = list(range(KC)) + list(range(k - 3 - KC, k - 3))
    chunks = [walk[c:c + KC] for c in range(0, len(walk), KC)]
    ids, vals = tb.ids.numpy(), tb.vals.numpy()
    kinds = [fiber_kind(f, k) for f in ids]
    runs = touter.fiber_chunk_starts(tb, KC).numpy().T
    if lists in ("contiguous", "aligned_gaps"):
        assert all(aligned_chunk(ks) >= 0 for ks in chunks)
    else:
        assert any(aligned_chunk(ks) < 0 for ks in chunks)
    for f in range(tb.n_fibers):
        cur = 0
        for ks in chunks:
            col = np.full(KC, np.nan, np.float32)
            new, wrote = merge_fiber(ids[f], vals[f], kinds[f], cur, ks, col,
                                     runs[f])
            want = np.zeros(KC, np.float32)
            for s, i in enumerate(ids[f]):
                if i in ks:
                    want[ks.index(i)] = vals[f, s]
            np.testing.assert_array_equal(col[:len(ks)], want[:len(ks)])
            assert wrote == any(i in ks for i in ids[f])
            if kinds[f] == -1:
                assert new >= cur
                assert all(fiber_key(ids[f], s) > ks[-1]
                           for s in range(new, tb.cap))
            cur = new
    if case == "shuffled":
        assert -2 in kinds
    if case == "dense_b":
        assert all(kd >= 0 for kd in kinds)


@pytest.mark.parametrize("case", ["random", "dense_b", "k_ragged", "jump",
                                  "out_of_range_middle"])
def test_fiber_chunk_starts_match_loop(case):
    """``fiber_chunk_starts``: per aligned 32-wide K chunk q and ordered
    fiber, the first slot whose id is at least 32·q (ids out of range and
    PAD past every chunk), so that the chunk's entries are the slots up to
    the next chunk's start."""
    tb = chunk_operands(case, "spmm")[1]
    k = tb.minor_size
    starts = touter.fiber_chunk_starts(tb, KC)
    n_chunks = -(-k // KC)
    assert starts.shape == (n_chunks + 1, tb.n_fibers)
    assert starts.dtype == torch.int32 and starts.is_contiguous()
    ids = tb.ids.numpy()
    for f in range(tb.n_fibers):
        if fiber_kind(ids[f], k) == -2:
            continue
        key = [i if 0 <= i < k else INT_MAX for i in ids[f]]
        for q in range(n_chunks + 1):
            want = next((s for s, x in enumerate(key) if x >= q * KC),
                        tb.cap)
            assert int(starts[q, f]) == want, (f, q)


def scan_starts(ids, minor: int, chunk: int):
    """``fiber_scan_kernel``'s chunk starts for one fiber, in one pass as
    the kernel writes them: slot s writes the starts of the chunks after
    the largest chunk of the slots before it up to its own (PAD and ids
    out of range in chunk ``n``), and the chunks past them all start at
    ``cap``. Returns the starts (-1 where nothing was written) and the
    number of writes."""
    n = -(-minor // chunk)
    starts = [-1] * (n + 1)
    c_prev, writes = -1, 0
    for s, i in enumerate(ids):
        c = i // chunk if 0 <= i < minor else n
        for q in range(c_prev + 1, c + 1):
            starts[q], writes = s, writes + 1
        c_prev = max(c_prev, c)
    for q in range(c_prev + 1, n + 1):
        starts[q], writes = len(ids), writes + 1
    return starts, writes


@pytest.mark.parametrize("case", ["random", "shuffled", "dense_b",
                                  "k_ragged", "jump", "out_of_range_last"])
def test_fiber_scan_starts_match_plain(case):
    """The scan kernel's one-pass starts equal ``fiber_chunk_starts`` on
    every ordered fiber, with one write per chunk; a fiber out of order
    writes each chunk's start at most once too."""
    tb = chunk_operands(case, "spmm")[1]
    k = tb.minor_size
    want = touter.fiber_chunk_starts(tb, KC).numpy().T
    for f, ids in enumerate(tb.ids.numpy()):
        got, writes = scan_starts(ids, k, KC)
        assert writes <= len(got)
        if fiber_kind(ids, k) != -2:
            assert got == want[f].tolist(), f
            assert writes == len(got)


class FakeLib:
    """Stands in for a built kernel library: records each C entry's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def test_reference_wrappers_make_no_bincount(monkeypatch):
    """The three reference wrappers, run past their launch on CPU tensors
    (the kernel library stubbed), never call ``torch.bincount`` (a host
    sync), and each makes its C calls with the arguments their
    signatures declare: SpMM and Gustavson one, inner two (A's fiber scan,
    whose flags it compacts into live-k lists, then the launch)."""
    def no_bincount(*args, **kwargs):
        raise AssertionError("torch.bincount reads its range to the host")

    lib = FakeLib()
    monkeypatch.setattr(torch, "bincount", no_bincount)
    monkeypatch.setattr(_build, "load", lambda stem, signatures: lib)
    monkeypatch.setattr(_build, "require_cuda_operands", lambda *a: None)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    before = (dict(tspmm.launches), dict(tinner.launches),
              dict(tgust.launches))
    ta, tb = chunk_operands("random", "spmm")
    assert tspmm._spmm_reference_launch(ta, tb).shape == (200, 180)
    ta, tb = chunk_operands("random", "inner")
    assert tinner._inner_reference_launch(ta, tb).shape == (200, 180)
    ta, tb = chunk_operands("random", "gustavson")
    assert tgust._gustavson_reference_launch(ta, tb).shape == (200, 180)
    names = [name for name, _ in lib.calls]
    assert names == ["spmm_reference_launch", "fiber_scan_launch",
                     "inner_reference_launch", "gustavson_reference_launch"]
    for (name, args), sig in zip(lib.calls, (
            tspmm._SIGNATURES, tinner._SIGNATURES, tinner._SIGNATURES,
            tgust._SIGNATURES)):
        assert len(args) == len(sig[name])
    assert (tspmm.launches["spmm_reference"],
            tinner.launches["inner_reference"],
            tgust.launches["gustavson_reference"]) == (
        before[0]["spmm_reference"] + 1, before[1]["inner_reference"] + 1,
        before[2]["gustavson_reference"] + 1)
