"""The index logic of the port's outer-product SpGEMM kernels
(``repro_torch.kernels.spgemm_outer``), on the CPU: the reference body's
live-K lists and A slot ranges per M tile, the binary search that finds a
B fiber's run in an N window (in Python, as the kernels do it), and the
sparse body's row-order transposition of A, each against a numpy loop.
Then both kernels' walks, in Python over those outputs, rebuild the
product and are held against the JAX package's ``spgemm_outer`` in
interpret mode, at ``tests/test_kernels.py``'s tolerances (f32
``rtol=atol=1e-4``, bf16 ``2e-2``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.formats import ell as tell
from repro_torch.kernels import spgemm_inner as tinner
from repro_torch.kernels import spgemm_outer as touter
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
    """``fiber_kind_kernel``'s verdict on one fiber: -2 out of order
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
