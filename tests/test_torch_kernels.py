"""Parity of the PyTorch port's ops (``repro_torch.kernels.ops``) with the
JAX package's (``repro.kernels.ops``) for the dense GEMM, SpMM, mirrored
SpMM, and the inner- and outer-product SpGEMMs (the Gustavson SpGEMM's are
in ``tests/test_torch_gustavson.py``): the same numpy operands go
through the port's plain versions on the CPU and through the JAX Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them.
Tolerances are that file's: f32 ``rtol=atol=1e-4``, bf16 ``2e-2``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jF
from repro.formats import ell as jell
from repro.kernels import ops as jops
from repro_torch.formats import ell as tell
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spgemm_inner as tinner
from repro_torch.kernels import spgemm_outer as touter
from repro_torch.kernels import spmm as tspmm

# ``repro.kernels`` re-exports functions named like its modules.
jspmm = sys.modules["repro.kernels.spmm"]
jinner = sys.modules["repro.kernels.spgemm_inner"]
jouter = sys.modules["repro.kernels.spgemm_outer"]

SHAPES = [
    (128, 128, 128),   # single block
    (256, 128, 384),   # multi-block in M and N
    (100, 90, 70),     # ragged: exercises padding
    (128, 300, 256),   # ragged K
]
DENSITIES = [0.0, 0.05, 0.3]
DTYPES = ["float32", "bfloat16"]
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-4, atol=1e-4))


def sparse(rng, r, c, density):
    x = rng.standard_normal((r, c)).astype(np.float32)
    return x * (rng.random((r, c)) < density)


def exact_cap(x, major_axis):
    """The fullest fiber's occupancy: that fiber lands exactly at cap."""
    work = x if major_axis == 0 else x.T
    return max(int((work != 0).sum(axis=-1).max()), 1)


def to_jax(x, dtype):
    return jnp.asarray(x, JAX_DTYPE[dtype])


def to_torch(x, dtype):
    return torch.from_numpy(x).to(TORCH_DTYPE[dtype])


# One compiled program per (shape, axis, cap) instead of one per primitive.
jax_dense_to_ell = jax.jit(jF.dense_to_ell, static_argnums=(1, 2))


def ells(x, major_axis, dtype):
    cap = exact_cap(x, major_axis)
    return (jax_dense_to_ell(to_jax(x, dtype), major_axis, cap),
            tell.dense_to_ell(to_torch(x, dtype), major_axis, cap))


def assert_close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


def spmm_operands(shape, density, dtype, seed=2):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = sparse(rng, m, k, 1.0)
    b = sparse(rng, k, n, density)
    jb, tb = ells(b, 1, dtype)
    return a, b, jb, tb


def inner_operands(shape, density, dtype, seed=6):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = sparse(rng, m, k, density)
    b = sparse(rng, k, n, max(density, 0.05))
    ja, ta = ells(a, 0, dtype)
    jb, tb = ells(b, 1, dtype)
    return a, b, ja, ta, jb, tb


def outer_operands(shape, density, dtype, seed=5):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = sparse(rng, m, k, density)
    b = sparse(rng, k, n, max(density, 0.05))
    ja, ta = ells(a, 1, dtype)
    jb, tb = ells(b, 0, dtype)
    return a, b, ja, ta, jb, tb


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_matches_jax(shape, dtype, density):
    m, k, n = shape
    rng = np.random.default_rng(4)
    a = sparse(rng, m, k, density)
    b = sparse(rng, k, n, 1.0)
    want = jops.gemm(to_jax(a, dtype), to_jax(b, dtype), interpret=True)
    got = tops.gemm(to_torch(a, dtype), to_torch(b, dtype), device="cpu")
    assert got.shape == (m, n) and got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(got, tref.gemm_ref(to_torch(a, dtype), to_torch(b, dtype)),
                 dtype)


@pytest.mark.parametrize("method", ["sparse", "reference"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spmm_matches_jax(shape, dtype, density, method):
    a, b, jb, tb = spmm_operands(shape, density, dtype)
    want = jops.spmm(to_jax(a, dtype), jb, interpret=True, method=method)
    got = tops.spmm(to_torch(a, dtype), tb, method=method, device="cpu")
    assert got.shape == shape[::2] and got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(got, tref.spmm_ref(to_torch(a, dtype), tb), dtype)


@pytest.mark.parametrize("method", ["sparse", "reference"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spmm_mirror_matches_jax(shape, dtype, density, method):
    """Mirrored SpMM, with the JAX ELL carried into the port through
    numpy (``ell_from_numpy``)."""
    m, k, n = shape
    rng = np.random.default_rng(3)
    a = sparse(rng, m, k, density)
    b = sparse(rng, k, n, 1.0)
    ja = jax_dense_to_ell(to_jax(a, dtype), 0, exact_cap(a, 0))
    ta = tell.ell_from_numpy(np.asarray(ja.vals), np.asarray(ja.ids),
                             np.asarray(ja.lens), ja.shape, ja.major_axis,
                             "cpu")
    want = jops.spmm_mirror(ja, to_jax(b, dtype), interpret=True,
                            method=method)
    got = tops.spmm_mirror(ta, to_torch(b, dtype), method=method,
                           device="cpu")
    assert got.shape == (m, n)
    assert_close(got, want, dtype)
    assert_close(got, tref.spmm_mirror_ref(ta, to_torch(b, dtype)), dtype)


@pytest.mark.parametrize("method", ["sparse", "reference"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spgemm_outer_matches_jax(shape, dtype, density, method):
    a, b, ja, ta, jb, tb = outer_operands(shape, density, dtype)
    want = jops.spgemm_outer(ja, jb, interpret=True, method=method)
    got = tops.spgemm_outer(ta, tb, method=method, device="cpu")
    assert got.shape == shape[::2] and got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(got, tref.spgemm_outer_ref(ta, tb), dtype)


@pytest.mark.parametrize("method", ["sparse", "reference"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spgemm_inner_matches_jax(shape, dtype, density, method):
    a, b, ja, ta, jb, tb = inner_operands(shape, density, dtype)
    want = jops.spgemm_inner(ja, jb, interpret=True, method=method)
    got = tops.spgemm_inner(ta, tb, method=method, device="cpu")
    assert got.shape == shape[::2] and got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(got, tref.spgemm_inner_ref(ta, tb), dtype)


@pytest.mark.parametrize("tile", [1, 8, 16, 50, 128])
@pytest.mark.parametrize("major_axis", [0, 1])
def test_tile_occupancy_matches_jax(tile, major_axis):
    rng = np.random.default_rng(3)
    x = sparse(rng, 60, 70, 0.1)
    x[8:24, :] = 0
    x[:, 30:45] = 0
    j, t = ells(x, major_axis, "float32")
    want = np.asarray(jell.tile_occupancy(j, tile))
    got = tell.tile_occupancy(t, tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def recorder(monkeypatch, module, names):
    """Wrap ``module``'s body functions so each call records its name."""
    seen = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            seen.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)
    return seen


# SpMM densities on both sides of 2·cap <= K, inner ones on both sides of
# 4·cap_a <= K; outer shapes on both sides of the 8 MiB table budget
# (4·K·(M+N) is 0.5 MiB at 256x256x256 and 11 MiB at 1024x1280x1024).
@pytest.mark.parametrize("op,shape,density", [
    ("spmm", (128, 128, 128), 0.05), ("spmm", (128, 128, 128), 1.0),
    ("spmm", (128, 300, 256), 0.3), ("spmm", (128, 300, 256), 1.0),
    ("spmm", (100, 90, 70), 0.05), ("spmm", (100, 90, 70), 0.3),
    ("inner", (128, 300, 256), 0.05), ("inner", (128, 300, 256), 0.3),
    ("outer", (256, 256, 256), 0.05), ("outer", (256, 256, 256), 0.3),
    ("outer", (1024, 1280, 1024), 0.01),
])
def test_auto_routes_to_the_same_body(monkeypatch, op, shape, density):
    dtype = "float32"
    if op == "spmm":
        jax_seen = recorder(monkeypatch, jspmm,
                            ["_spmm_sparse", "_spmm_reference"])
        port_seen = recorder(monkeypatch, tspmm,
                             ["spmm_sparse", "spmm_reference"])
        a, b, jb, tb = spmm_operands(shape, density, dtype)
        jops.spmm.clear_cache()        # trace again, so the body records
        want = jops.spmm(to_jax(a, dtype), jb, interpret=True)
        got = tops.spmm(to_torch(a, dtype), tb, device="cpu")
    elif op == "inner":
        jax_seen = recorder(monkeypatch, jinner,
                            ["_inner_sparse", "_inner_reference"])
        port_seen = recorder(monkeypatch, tinner,
                             ["inner_sparse", "inner_reference"])
        a, b, ja, ta, jb, tb = inner_operands(shape, density, dtype)
        jops.spgemm_inner.clear_cache()
        want = jops.spgemm_inner(ja, jb, interpret=True)
        got = tops.spgemm_inner(ta, tb, device="cpu")
    else:
        jax_seen = recorder(monkeypatch, jouter,
                            ["_outer_sparse", "_outer_reference"])
        port_seen = recorder(monkeypatch, touter,
                             ["outer_sparse", "outer_reference"])
        a, b, ja, ta, jb, tb = outer_operands(shape, density, dtype)
        jops.spgemm_outer.clear_cache()
        want = jops.spgemm_outer(ja, jb, interpret=True)
        got = tops.spgemm_outer(ta, tb, device="cpu")
    assert len(jax_seen) == len(port_seen) == 1
    assert jax_seen[0].split("_")[-1] == port_seen[0].split("_")[-1]
    assert_close(got, want, dtype)


def test_unported_classes_raise():
    """No dataflow class is left unported: ``DISPATCH`` has an op for
    every class, and each runs (no ``NotImplementedError``) and gives the
    product on operands in its formats."""
    from repro_torch.formats.taxonomy import DataflowClass

    assert set(tops.DISPATCH) == set(DataflowClass)
    rng = np.random.default_rng(1)
    a = sparse(rng, 64, 48, 0.3)
    b = sparse(rng, 48, 40, 0.3)
    axes = {DataflowClass.GEMM: (None, None),
            DataflowClass.SPMM: (None, 1),
            DataflowClass.SPGEMM_INNER: (0, 1),
            DataflowClass.SPGEMM_OUTER: (1, 0),
            DataflowClass.SPGEMM_GUSTAVSON: (1, 1)}
    for cls, (ax_a, ax_b) in axes.items():
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        if ax_a is not None:
            ta = tell.dense_to_ell(ta, ax_a, exact_cap(a, ax_a))
        if ax_b is not None:
            tb = tell.dense_to_ell(tb, ax_b, exact_cap(b, ax_b))
        got = tops.dispatch(cls, ta, tb, device="cpu")
        np.testing.assert_allclose(got.numpy(), a @ b, **tol("float32"))


def test_cpu_wrappers_never_launch():
    """On CPU tensors the body wrappers run the plain versions and count
    no kernel launch."""
    a, b, _, tb = spmm_operands((64, 64, 64), 0.3, "float32")
    ta_, tb_ = torch.from_numpy(a), tb
    before = (dict(tspmm.launches), dict(touter.launches),
              dict(tinner.launches), dict(tgemm.launches))
    tspmm.spmm_sparse(ta_, tb_, bn=64)
    tspmm.spmm_reference(ta_, tb_)
    _, _, _, oa, _, ob = outer_operands((64, 64, 64), 0.3, "float32")
    touter.outer_sparse(oa, ob, bm=64, bn=64)
    touter.outer_reference(oa, ob)
    _, _, _, ia, _, ib = inner_operands((64, 64, 64), 0.3, "float32")
    tinner.inner_sparse(ia, ib, bm=64, bn=64, fc=16)
    tinner.inner_reference(ia, ib, bm=64, bn=64, bk=64)
    tgemm.gemm(ta_, ta_)
    assert (tspmm.launches, touter.launches, tinner.launches,
            tgemm.launches) == before


@pytest.mark.parametrize("major_axis", [0, 1])
def test_inner_reference_flags_unordered_fibers(major_axis):
    """The reference body reads a K step of an ordered fiber (live ids in
    range and ascending, PAD slots last) as one run of slots and scans the
    others whole: ``dense_to_ell`` fibers are all ordered, and a fiber
    whose slots were shuffled, or that holds an id out of range, is
    flagged exactly when its order broke."""
    rng = np.random.default_rng(3)
    x = sparse(rng, 96, 80, 0.2)
    e = tell.dense_to_ell(torch.from_numpy(x), major_axis,
                          exact_cap(x, major_axis) + 4, strict=True)
    assert tinner._ordered(e).all()
    perm = torch.from_numpy(np.stack([rng.permutation(e.cap)
                                      for _ in range(e.n_fibers)]))
    ids = torch.gather(e.ids, 1, perm)
    shuffled = tell.EllMatrix(torch.gather(e.vals, 1, perm), ids, e.lens,
                              e.shape, e.major_axis)
    key = np.where(ids.numpy() >= 0, ids.numpy(), e.minor_size)
    want = (np.diff(key, axis=1) >= 0).all(axis=1)
    assert not want.all()
    np.testing.assert_array_equal(tinner._ordered(shuffled).numpy(), want)
    # An id outside [0, minor_size) in the last slot of fiber 0 (which
    # keeps the order) marks that fiber, and only it, as not ordered.
    ids = e.ids.clone()
    ids[0, -1] = e.minor_size
    bad = tell.EllMatrix(e.vals, ids, e.lens, e.shape, e.major_axis)
    np.testing.assert_array_equal(tinner._ordered(bad).numpy(),
                                  np.arange(e.n_fibers) != 0)


def with_bad_id(j, t, where, tile=128):
    """Both packages' ELLs with the last live slot of the middle or last
    fiber holding an id past the minor size, at or beyond ``(n_tiles +
    1)·tile`` (order kept)."""
    ids = np.asarray(j.ids).copy()
    f = ids.shape[0] // 2 if where == "middle" else ids.shape[0] - 1
    live = int((ids[f] >= 0).sum())
    assert live >= 1
    ids[f, live - 1] = (-(-t.minor_size // tile) + 1) * tile + 7
    j = jF.EllMatrix(vals=j.vals, ids=jnp.asarray(ids), lens=j.lens,
                     shape=j.shape, major_axis=j.major_axis)
    t = tell.EllMatrix(t.vals, torch.from_numpy(ids), t.lens, t.shape,
                       t.major_axis)
    return j, t


@pytest.mark.parametrize("where", ["middle", "last"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spmm_plain_drops_ids_out_of_range_like_jax(dtype, where):
    """``spmm_plain`` on a B fiber holding an id past K equals JAX's
    reference body in interpret mode, which drops the id (the sparse
    bodies do not take such operands)."""
    a, b, jb, tb = spmm_operands((256, 256, 256), 0.3, dtype)
    jb, tb = with_bad_id(jb, tb, where)
    want = jops.spmm(to_jax(a, dtype), jb, interpret=True,
                     method="reference")
    got = tspmm.spmm_plain(to_torch(a, dtype), tb)
    assert got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(tops.spmm(to_torch(a, dtype), tb, method="reference",
                           device="cpu"), want, dtype)


@pytest.mark.parametrize("where", ["middle", "last"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spgemm_inner_plain_drops_ids_out_of_range_like_jax(dtype, where):
    """``spgemm_inner_plain`` on an A row fiber and a B fiber each holding
    an id past K equals JAX's reference body in interpret mode."""
    a, b, ja, ta, jb, tb = inner_operands((256, 256, 256), 0.3, dtype)
    ja, ta = with_bad_id(ja, ta, where)
    jb, tb = with_bad_id(jb, tb, where)
    want = jops.spgemm_inner(ja, jb, interpret=True, method="reference")
    got = tinner.spgemm_inner_plain(ta, tb)
    assert got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(tops.spgemm_inner(ta, tb, method="reference", device="cpu"),
                 want, dtype)
