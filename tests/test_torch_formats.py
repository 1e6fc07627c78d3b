"""Parity of the PyTorch port's ELL format (``repro_torch.formats.ell``)
with the JAX package's (``repro.formats.ell``): the same numpy inputs go
through both, and ids, lens and values must agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.formats import ell as jell
from repro_torch.formats import ell as tell


def sparse(rng, r, c, density):
    x = rng.standard_normal((r, c)).astype(np.float32)
    return x * (rng.random((r, c)) < density)


def fiber_max(x, major_axis):
    work = x if major_axis == 0 else x.T
    return int((work != 0).sum(axis=-1).max()) if work.size else 0


# One compiled program per (shape, axis, cap) instead of one per primitive.
jax_dense_to_ell = jax.jit(jell.dense_to_ell, static_argnums=(1, 2, 3))


def both(x, major_axis, cap):
    j = jax_dense_to_ell(jnp.asarray(x), major_axis, cap)
    t = tell.dense_to_ell(torch.from_numpy(x), major_axis, cap)
    return j, t


def assert_same_ell(j, t):
    vals, ids, lens, shape, major_axis = tell.ell_to_numpy(t)
    np.testing.assert_array_equal(ids, np.asarray(j.ids))
    np.testing.assert_array_equal(lens, np.asarray(j.lens))
    np.testing.assert_array_equal(vals, np.asarray(j.vals, np.float32))
    assert t.ids.dtype == torch.int32 and t.lens.dtype == torch.int32
    assert shape == tuple(j.shape) and major_axis == j.major_axis


# Caps: exact occupancy (the fullest fiber lands exactly at cap), a bucket
# above it, one below it (truncation), and one above the minor size (the
# width < cap padding branch).
@pytest.mark.parametrize("shape", [(24, 40), (7, 130)])
@pytest.mark.parametrize("major_axis", [0, 1])
@pytest.mark.parametrize("density", [0.05, 1.0])
@pytest.mark.parametrize("cap_mode", ["exact", "bucket", "truncate", "wide"])
def test_dense_to_ell_matches_jax(shape, major_axis, density, cap_mode):
    rng = np.random.default_rng(0)
    x = sparse(rng, *shape, density)
    need = max(fiber_max(x, major_axis), 1)
    minor = shape[1 - major_axis]
    cap = {"exact": need, "bucket": tell.bucket_capacity(need),
           "truncate": max(need // 2, 1), "wide": minor + 9}[cap_mode]
    j, t = both(x, major_axis, cap)
    assert_same_ell(j, t)
    if cap_mode == "exact":
        assert int(t.lens.max()) == cap
    if cap_mode != "truncate":
        back = tell.ell_to_dense(t).numpy()
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(
            back, np.asarray(jax.jit(jell.ell_to_dense)(j)))


@pytest.mark.parametrize("major_axis", [0, 1])
def test_all_zero_matrix(major_axis):
    x = np.zeros((16, 24), np.float32)
    j, t = both(x, major_axis, 8)
    assert_same_ell(j, t)
    assert int(t.lens.sum()) == 0
    assert bool((t.ids == tell.PAD_ID).all())


def test_strict_overflow_raises_like_jax():
    rng = np.random.default_rng(1)
    x = sparse(rng, 12, 30, 0.5)
    need = fiber_max(x, 0)
    with pytest.raises(ValueError, match="cap="):
        jell.dense_to_ell(jnp.asarray(x), 0, need - 1, strict=True)
    with pytest.raises(ValueError, match="cap="):
        tell.dense_to_ell(torch.from_numpy(x), 0, need - 1, strict=True)
    j = jell.dense_to_ell(jnp.asarray(x), 0, need, strict=True)
    t = tell.dense_to_ell(torch.from_numpy(x), 0, need, strict=True)
    assert_same_ell(j, t)


def test_bucket_capacity_matches_jax():
    for cap in range(0, 300, 7):
        for align in (1, 8, 16):
            for max_cap in (None, 1, 37, 128, 1000):
                assert (tell.bucket_capacity(cap, align, max_cap)
                        == jell.bucket_capacity(cap, align, max_cap))


@pytest.mark.parametrize("block,chunk", [(8, 1), (8, 4), (16, 16), (32, 5)])
def test_block_chunk_counts_matches_jax(block, chunk):
    rng = np.random.default_rng(2)
    x = sparse(rng, 40, 64, 0.2)
    x[:, 16:32] = 0                               # an all-empty fiber block
    x[:14, 3] = 1.0                               # one long fiber
    j, t = both(x, 1, max(fiber_max(x, 1), 1))
    want = np.asarray(jell.block_chunk_counts(j, block, chunk))
    got = tell.block_chunk_counts(t, block, chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 8, 16, 50, 128])
@pytest.mark.parametrize("major_axis", [0, 1])
def test_block_window_nnz_matches_jax(window, major_axis):
    rng = np.random.default_rng(3)
    x = sparse(rng, 60, 70, 0.1)
    x[8:24, :] = 0
    x[:, 30:45] = 0
    j, t = both(x, major_axis, max(fiber_max(x, major_axis), 1))
    want = np.asarray(jell.block_window_nnz(j, window))
    got = tell.block_window_nnz(t, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_capacity_matches_jax():
    rng = np.random.default_rng(4)
    x = sparse(rng, 20, 33, 0.2)
    j, t = both(x, 0, max(fiber_max(x, 0), 1))
    assert_same_ell(jell.pad_capacity(j, 40), tell.pad_capacity(t, 40))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_ell_carried_into_the_port(dtype):
    """A JAX EllMatrix handed over through numpy densifies to the same
    matrix in the port, and round-trips back unchanged."""
    rng = np.random.default_rng(5)
    x = sparse(rng, 30, 45, 0.15)
    j = jell.dense_to_ell(jnp.asarray(x, dtype), 1, max(fiber_max(x, 1), 1))
    t = tell.ell_from_numpy(np.asarray(j.vals), np.asarray(j.ids),
                            np.asarray(j.lens), j.shape, j.major_axis, "cpu")
    want_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert t.vals.dtype == want_dtype
    assert_same_ell(j, t)
    np.testing.assert_array_equal(
        tell.ell_to_dense(t).float().numpy(),
        np.asarray(jell.ell_to_dense(j), np.float32))


def with_ids_out_of_range(x, major_axis, tile, where):
    """Both packages' ELLs of ``x`` (row fibers or column fibers, each at
    its fullest fiber's capacity) with the last live slot of the middle or
    the last fiber holding an id at ``(n_tiles + 1)·tile``, and another
    live slot of that fiber holding one far past it, so the fiber keeps its
    order."""
    j, t = both(x, major_axis, max(fiber_max(x, major_axis), 1))
    ids = np.asarray(j.ids).copy()
    f = ids.shape[0] // 2 if where == "middle" else ids.shape[0] - 1
    live = int((ids[f] >= 0).sum())
    assert live >= 2
    n_tiles = -(-t.minor_size // tile)
    ids[f, live - 2] = (n_tiles + 1) * tile
    ids[f, live - 1] = (n_tiles + 1) * tile + 5 * tile + 3
    j = jell.EllMatrix(vals=j.vals, ids=jnp.asarray(ids), lens=j.lens,
                       shape=j.shape, major_axis=j.major_axis)
    t = tell.EllMatrix(t.vals, torch.from_numpy(ids), t.lens, t.shape,
                       t.major_axis)
    return j, t, f


@pytest.mark.parametrize("where", ["middle", "last"])
@pytest.mark.parametrize("tile", [16, 50, 128])
@pytest.mark.parametrize("major_axis", [0, 1])
def test_tile_occupancy_drops_ids_out_of_range_like_jax(major_axis, tile,
                                                        where):
    """An id at or past ``(n_tiles + 1)·tile`` counts nowhere, as in the
    JAX package: it neither spills into the next fiber's tiles nor breaks
    the last fiber's row."""
    rng = np.random.default_rng(7)
    x = sparse(rng, 60, 70, 0.2)
    j, t, f = with_ids_out_of_range(x, major_axis, tile, where)
    want = np.asarray(jell.tile_occupancy(j, tile))
    got = tell.tile_occupancy(t, tile)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    clean = tell.tile_occupancy(both(x, major_axis, t.cap)[1], tile).numpy()
    assert got.numpy()[f].sum() == clean[f].sum() - 2
    np.testing.assert_array_equal(np.delete(got.numpy(), f, axis=0),
                                  np.delete(clean, f, axis=0))


@pytest.mark.parametrize("where", ["middle", "last"])
@pytest.mark.parametrize("window", [16, 50, 128])
@pytest.mark.parametrize("major_axis", [0, 1])
def test_block_window_nnz_drops_ids_out_of_range_like_jax(major_axis,
                                                          window, where):
    rng = np.random.default_rng(8)
    x = sparse(rng, 60, 70, 0.2)
    j, t, _ = with_ids_out_of_range(x, major_axis, window, where)
    want = np.asarray(jell.block_window_nnz(j, window))
    got = tell.block_window_nnz(t, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    clean = tell.block_window_nnz(both(x, major_axis, t.cap)[1], window)
    assert int(got.sum()) == int(clean.sum()) - 2


@pytest.mark.parametrize("where", ["middle", "last"])
def test_ell_to_dense_drops_ids_out_of_range_like_jax(where):
    rng = np.random.default_rng(9)
    x = sparse(rng, 40, 50, 0.3)
    j, t, _ = with_ids_out_of_range(x, 1, 16, where)
    np.testing.assert_array_equal(tell.ell_to_dense(t).numpy(),
                                  np.asarray(jell.ell_to_dense(j)))


# ------------------------------------------- converters and capacity helpers
@pytest.mark.parametrize("major_axis", [0, 1])
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_required_and_check_capacity_match_jax(major_axis, density):
    rng = np.random.default_rng(3)
    x = sparse(rng, 33, 47, density)
    need = tell.required_capacity(torch.from_numpy(x), major_axis)
    assert need == jell.required_capacity(x, major_axis)
    assert tell.required_capacity(x, major_axis, align=4) == \
        jell.required_capacity(x, major_axis, align=4)
    for cap in (need // 2, need - 1, need, need + 8):
        assert tell.check_capacity(torch.from_numpy(x), major_axis, cap) \
            == jell.check_capacity(jnp.asarray(x), major_axis, cap)


@pytest.mark.parametrize("operand,src,dst", [
    ("A", "A_UMUK", "A_UMCK"), ("A", "A_UMUK", "A_UKCM"),
    ("A", "A_UMCK", "A_UKCM"), ("A", "A_UKCM", "A_UMUK"),
    ("B", "B_UKUN", "B_UNCK"), ("B", "B_UKUN", "B_UKCN"),
    ("B", "B_UNCK", "B_UKCN"), ("B", "B_UKCN", "B_UKCN")])
def test_convert_matches_jax(operand, src, dst):
    import sys

    from repro.formats import taxonomy as jtax
    from repro_torch.formats import convert as tconv
    from repro_torch.formats import taxonomy as ttax

    # ``repro.formats`` re-exports a function named like its module.
    jconv = sys.modules["repro.formats.convert"]
    rng = np.random.default_rng(4)
    x = sparse(rng, 40, 24, 0.2)
    cap = 16
    js, jd = getattr(jtax, src), getattr(jtax, dst)
    ts, td = getattr(ttax, src), getattr(ttax, dst)
    assert tconv.major_axis_for(td, operand) == \
        jconv.major_axis_for(jd, operand)
    j = jconv.convert(jconv.to_format(jnp.asarray(x), js, operand, cap),
                      js, jd, operand, cap)
    t = tconv.convert(tconv.to_format(torch.from_numpy(x), ts, operand,
                                      cap), ts, td, operand, cap)
    if td.is_dense:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    else:
        assert_same_ell(j, t)
    np.testing.assert_array_equal(tconv.to_dense(t).numpy(),
                                  np.asarray(jconv.to_dense(j)))
    for d in (0.0, 0.2, 1.0):
        assert tconv.conversion_bytes((40, 24), d, ts, td) == \
            jconv.conversion_bytes((40, 24), d, js, jd)


def test_convert_strict_raises_like_jax():
    import sys

    from repro.formats import taxonomy as jtax
    from repro_torch.formats import convert as tconv
    from repro_torch.formats import taxonomy as ttax

    jconv = sys.modules["repro.formats.convert"]
    x = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="strict"):
        jconv.to_format(jnp.asarray(x), jtax.A_UMCK, "A", 4, strict=True)
    with pytest.raises(ValueError, match="strict"):
        tconv.to_format(torch.from_numpy(x), ttax.A_UMCK, "A", 4,
                        strict=True)
    with pytest.raises(ValueError):
        tconv.major_axis_for(ttax.A_UMCK, "C")


def test_package_surface_re_exports():
    """``repro_torch``'s ``__init__`` files re-export what ``repro``'s do
    (bar the TPU-only names), and a module stays a module where ``repro``
    re-exports a function of the same name over it."""
    import repro.formats as jformats
    import repro_torch.core as tcore
    import repro_torch.formats as tformats
    import repro_torch.kernels as tkernels
    from repro_torch.core import execute_schedule  # noqa: F401

    assert set(jformats.__all__) - set(tformats.__all__) == {
        "ell_onehot_expand"}
    for name in tformats.__all__:
        assert hasattr(tformats, name), name
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    assert tcore.execute_schedule is tcore.hetero_matmul.execute_schedule
    from importlib import import_module
    for pkg, mod in [("kernels", m) for m in (
            "gemm", "spmm", "spgemm_inner", "spgemm_outer",
            "spgemm_gustavson")] + [("core", "hetero_matmul"),
                                    ("formats", "convert")]:
        name = f"repro_torch.{pkg}.{mod}"
        assert getattr(import_module(f"repro_torch.{pkg}"), mod) is \
            import_module(name), name
    assert tkernels.DISPATCH is tkernels.ops.DISPATCH
