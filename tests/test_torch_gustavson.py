"""Parity of the PyTorch port's Gustavson SpGEMM
(``repro_torch.kernels.spgemm_gustavson`` through ``ops``) with the JAX
package's, and of the cost hook beside the dispatch (``ops.op_cost``,
``costmodel.sw_kernel_cost``, ``execute_schedule(cost_sink=...)``): the same
numpy operands go through the port's plain versions on the CPU and through
the JAX Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
them. Tolerances are that file's: f32 ``rtol=atol=1e-4``, bf16 ``2e-2``.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jF
from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import workloads as jwl
from repro.formats.taxonomy import DataflowClass as JClass
from repro.kernels import ops as jops
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import hetero_matmul as thm
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.formats import ell as tell
from repro_torch.formats.taxonomy import DataflowClass as TClass
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spgemm_gustavson as tgust
from repro_torch.kernels import spgemm_inner as tinner

# ``repro.kernels`` and ``repro.core`` re-export functions named like
# their modules.
jgust = sys.modules["repro.kernels.spgemm_gustavson"]
jhm = sys.modules["repro.core.hetero_matmul"]

SHAPES = [
    (128, 128, 128),   # single block
    (256, 128, 384),   # multi-block in M and N
    (100, 90, 70),     # ragged: exercises padding
    (128, 300, 256),   # ragged K
]
DENSITIES = [0.0, 0.05, 0.3]
DTYPES = ["float32", "bfloat16"]
METHODS = ["auto", "sparse", "reference"]
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


jax_dense_to_ell = jax.jit(jF.dense_to_ell, static_argnums=(1, 2))


def ells(x, dtype, cap=None):
    """Column fibers (``major_axis=1``) of ``x`` in both packages."""
    cap = cap or exact_cap(x, 1)
    return (jax_dense_to_ell(jnp.asarray(x, JAX_DTYPE[dtype]), 1, cap),
            tell.dense_to_ell(torch.from_numpy(x).to(TORCH_DTYPE[dtype]), 1,
                              cap))


def operands(shape, density, dtype, seed=8):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = sparse(rng, m, k, density)
    b = sparse(rng, k, n, max(density, 0.05))
    ja, ta = ells(a, dtype)
    jb, tb = ells(b, dtype)
    return a, b, ja, ta, jb, tb


def assert_close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spgemm_gustavson_matches_jax(shape, dtype, density, method):
    a, b, ja, ta, jb, tb = operands(shape, density, dtype)
    want = jops.spgemm_gustavson(ja, jb, interpret=True, method=method)
    got = tops.spgemm_gustavson(ta, tb, method=method, device="cpu")
    assert got.shape == shape[::2] and got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(got, tref.spgemm_gustavson_ref(ta, tb), dtype)


@pytest.mark.parametrize("method", ["sparse", "reference"])
def test_gustavson_fiber_at_exact_capacity(method):
    """A's fiber 5 and B's fiber 3 each hold exactly their capacity (the
    capacity is the fullest fiber's count, and no other fiber reaches it),
    so a body that stops one slot short drops an entry."""
    rng = np.random.default_rng(2)
    a = sparse(rng, 150, 200, 0.02)
    b = sparse(rng, 200, 90, 0.02)
    a[:, 5] = 0
    a[np.arange(0, 150, 7)[:20], 5] = 1.5
    b[:, 3] = 0
    b[np.arange(0, 200, 9)[:20], 3] = -2.0
    assert exact_cap(a, 1) == exact_cap(b, 1) == 20
    _, ta = ells(a, "float32")
    _, tb = ells(b, "float32")
    assert int(ta.lens[5]) == ta.cap and int(tb.lens[3]) == tb.cap
    got = tops.spgemm_gustavson(ta, tb, method=method, device="cpu")
    np.testing.assert_allclose(got.numpy(), a @ b, **tol("float32"))


@pytest.mark.parametrize("method", METHODS)
def test_gustavson_zero_matrices(method):
    """All-zero operands (every fiber empty, capacity 1 of padding) give
    an all-zero product in the operands' dtype, as on the JAX side."""
    a = np.zeros((96, 80), np.float32)
    b = np.zeros((80, 112), np.float32)
    ja, ta = ells(a, "bfloat16")
    jb, tb = ells(b, "bfloat16")
    got = tops.spgemm_gustavson(ta, tb, method=method, device="cpu")
    want = jops.spgemm_gustavson(ja, jb, interpret=True, method=method)
    assert got.dtype == torch.bfloat16 and got.shape == (96, 112)
    assert not got.float().any()
    assert_close(got, want, "bfloat16")


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


# B densities on both sides of 4·cap_b <= K.
@pytest.mark.parametrize("shape,density", [
    ((128, 300, 256), 0.05), ((128, 300, 256), 0.3),
    ((100, 90, 70), 0.05), ((256, 512, 128), 0.05),
])
def test_gustavson_auto_routes_to_the_same_body(monkeypatch, shape, density):
    jax_seen = recorder(monkeypatch, jgust,
                        ["_gustavson_sparse", "_gustavson_reference"])
    port_seen = recorder(monkeypatch, tgust,
                         ["gustavson_sparse", "gustavson_reference"])
    a, b, ja, ta, jb, tb = operands(shape, density, "float32")
    jops.spgemm_gustavson.clear_cache()   # trace again, so the body records
    want = jops.spgemm_gustavson(ja, jb, interpret=True)
    got = tops.spgemm_gustavson(ta, tb, device="cpu")
    assert len(jax_seen) == len(port_seen) == 1
    assert jax_seen[0].split("_")[-1] == port_seen[0].split("_")[-1]
    ap = tops.spgemm_gustavson_operands(ta, tb)[1]
    assert port_seen[0].endswith(tgust.resolve_method("auto", ap.shape[0],
                                                      ap.cap))
    assert_close(got, want, "float32")


def test_resolve_method_rejects_unknown_names():
    assert tgust.resolve_method("sparse", 64, 64) == "sparse"
    assert tgust.resolve_method("auto", 64, 16) == "sparse"
    assert tgust.resolve_method("auto", 64, 17) == "reference"
    with pytest.raises(ValueError, match="unknown spgemm_gustavson method"):
        tgust.resolve_method("dense", 64, 16)


@pytest.mark.parametrize("shape", SHAPES + [(300, 260, 520)])
@pytest.mark.parametrize("blocks", [(None, None), (64, 32)])
def test_gustavson_operands_match_jax(shape, blocks):
    """The padded operands the kernel gets: the same fiber counts, minor
    sizes and bucketed capacities as the JAX side's ``_pad_ell`` with its
    ``_auto_block`` blocks, the same ids, and the same blocks."""
    bm, bn = blocks
    _, _, ja, ta, jb, tb = operands(shape, 0.05, "float32")
    jbm = jops._auto_block(shape[0], bm)
    jbn = jops._auto_block(shape[2], bn)
    jap, jbp = jops._pad_ell(ja, 128, jbm), jops._pad_ell(jb, jbn, 128)
    ap, bp, tbm, tbn = tops.spgemm_gustavson_operands(ta, tb, bm=bm, bn=bn)
    assert (tbm, tbn) == (jbm, jbn)
    for t, j in ((ap, jap), (bp, jbp)):
        assert (t.shape, t.cap, t.n_fibers, t.major_axis) == (
            tuple(j.shape), j.cap, j.n_fibers, j.major_axis)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.lens.numpy(), np.asarray(j.lens))


def test_gustavson_cpu_wrappers_never_launch():
    """On CPU tensors the body wrappers run the plain version and count no
    kernel launch."""
    _, _, _, ta, _, tb = operands((64, 64, 64), 0.3, "float32")
    before = dict(tgust.launches)
    tgust.gustavson_sparse(ta, tb, bm=64, bn=64, fc=16)
    tgust.gustavson_reference(ta, tb, bn=64, bk=64)
    tgust.spgemm_gustavson(ta, tb, method="sparse")
    assert tgust.launches == before


def test_gustavson_fibers_out_of_order():
    """Live slots shuffled within each fiber (ids no longer ascending,
    PAD slots still last), as ``ell_from_numpy`` may deliver them: the
    plain version and the oracle still give ``a @ b``, and the kernels'
    order flag marks exactly the shuffled fibers."""
    rng = np.random.default_rng(4)
    a = sparse(rng, 120, 100, 0.2)
    b = sparse(rng, 100, 90, 0.2)
    _, ta = ells(a, "float32")
    _, tb = ells(b, "float32")

    def shuffle(e):
        key = rng.random(e.ids.shape) + 2.0 * (e.ids.numpy() < 0)
        perm = torch.from_numpy(np.argsort(key, axis=1))
        return dataclasses.replace(e, vals=e.vals.gather(1, perm),
                                   ids=e.ids.gather(1, perm))

    sa, sb = shuffle(ta), shuffle(tb)
    for e, s in ((ta, sa), (tb, sb)):
        assert bool(tinner._ordered(e).all())
        key = np.where(s.ids.numpy() >= 0, s.ids.numpy(), s.minor_size)
        want = (np.diff(key, axis=1) >= 0).all(axis=1)
        assert not want.all()
        np.testing.assert_array_equal(tinner._ordered(s).numpy(), want)
    for method in ("sparse", "reference"):
        got = tops.spgemm_gustavson(sa, sb, method=method, device="cpu")
        np.testing.assert_allclose(got.numpy(), a @ b, **tol("float32"))
    np.testing.assert_allclose(tref.spgemm_gustavson_ref(sa, sb).numpy(),
                               a @ b, **tol("float32"))


# --------------------------------------------------------------- cost hook
def cost_operands(cls_name, mirror, rng):
    """One operand pair per class, in its REQUIRED_FORMATS, for both
    packages (dense operands as jnp/torch arrays, fibers as ELLs)."""
    m, k, n = 96, 160, 72
    a = sparse(rng, m, k, 0.2)
    b = sparse(rng, k, n, 0.3)
    axes = {"gemm": (None, None), "spmm": ((0, None) if mirror
                                            else (None, 1)),
            "spgemm_inner": (0, 1), "spgemm_outer": (1, 0),
            "spgemm_gustavson": (1, 1)}[cls_name]

    def both(x, ax):
        if ax is None:
            return jnp.asarray(x), torch.from_numpy(x)
        cap = exact_cap(x, ax)
        return (jax_dense_to_ell(jnp.asarray(x), ax, cap),
                tell.dense_to_ell(torch.from_numpy(x), ax, cap))

    (ja, ta), (jb, tb) = both(a, axes[0]), both(b, axes[1])
    return ja, jb, ta, tb


@pytest.mark.parametrize("blocks", [(None, None), (128, 64)])
@pytest.mark.parametrize("cls_name,mirror", [
    ("gemm", False), ("spmm", False), ("spmm", True),
    ("spgemm_inner", False), ("spgemm_outer", False),
    ("spgemm_gustavson", False),
])
def test_op_cost_matches_jax(cls_name, mirror, blocks):
    ja, jb, ta, tb = cost_operands(cls_name, mirror,
                                   np.random.default_rng(9))
    bm, bn = blocks
    want = jops.op_cost(JClass(cls_name), ja, jb, bm=bm, bn=bn,
                        mirror=mirror)
    got = tops.op_cost(TClass(cls_name), ta, tb, bm=bm, bn=bn,
                       mirror=mirror)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.intensity == want.intensity


@pytest.mark.parametrize("method", ["auto", "sparse", "reference"])
@pytest.mark.parametrize("kind", ["gemm", "spmm", "inner", "outer",
                                  "gustavson"])
def test_sw_kernel_cost_matches_jax(kind, method):
    """Every kind and body, at shapes on both sides of each "auto" rule
    (the outer product's on both sides of its 8 MiB table budget)."""
    for m, k, n, nnz_a, nnz_b, cap_a, cap_b in [
            (256, 512, 384, 4000.0, 9000.0, 16, 64),
            (1024, 1280, 1024, 70000.0, 20000.0, 512, 640),
            (128, 128, 128, None, None, None, None)]:
        kw = dict(nnz_a=nnz_a, nnz_b=nnz_b, cap_a=cap_a, cap_b=cap_b,
                  method=method, bm=128, bn=64)
        got = tcm.sw_kernel_cost(kind, m, k, n, **kw)
        want = jcm.sw_kernel_cost(kind, m, k, n, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {c.value: v for c, v in tcm.SW_KIND.items()} == {
        c.value: v for c, v in jcm.SW_KIND.items()}
    assert (tcm.W_MAC, tcm.W_GATHER, tcm.W_SCATTER, tcm.W_EXPAND) == (
        jcm.W_MAC, jcm.W_GATHER, jcm.W_SCATTER, jcm.W_EXPAND)
    with pytest.raises(ValueError, match="unknown sw kernel kind"):
        tcm.sw_kernel_cost("dense", 8, 8, 8)


@pytest.mark.parametrize("name,max_elems", [
    ("citeseer", 1 << 17), ("gnmt", 1 << 14), ("speech", 1 << 15),
])
def test_execute_schedule_cost_sink_matches_jax(name, max_elems):
    """``aespa_opt``'s schedules with the cost hook on (Gustavson whole at
    citeseer and gnmt, mirrored SpMM beside inner at speech): one cost per
    dispatched partition, equal to the JAX executor's, and the same
    output."""
    a, b, dims = twl.synthesize(twl.BY_NAME[name], seed=0,
                                max_elems=max_elems)
    jw0 = jwl.BY_NAME[name]
    jw = jwl.Workload(jw0.name, jw0.application, *dims, jw0.d_mk, jw0.d_kn)
    tw = twl.Workload(jw0.name, jw0.application, *dims, jw0.d_mk, jw0.d_kn)
    js = jsched.schedule_single_kernel(jdse.aespa_opt(), jw)
    ts = tsched.schedule_single_kernel(tdse.aespa_opt(), tw)
    assert (TClass.SPGEMM_GUSTAVSON in {p.cls for p in ts.partitions}) == (
        name != "speech")
    jsink, tsink = [], []
    want = jhm.execute_schedule(a, b, js, block=64, cost_sink=jsink)
    got = thm.execute_schedule(a, b, ts, block=64, device="cpu",
                               cost_sink=tsink)
    assert len(tsink) == len([p for p in ts.partitions
                              if not p.region.empty])
    assert [dataclasses.asdict(c) for c in tsink] == [
        dataclasses.asdict(c) for c in jsink]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tol("float32"))
    np.testing.assert_allclose(got.numpy(), a @ b, **tol("float32"))


@pytest.mark.parametrize("where", ["middle", "last"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spgemm_gustavson_plain_drops_ids_out_of_range_like_jax(dtype,
                                                                 where):
    """``spgemm_gustavson_plain`` on an A fiber holding an id past M and a
    B fiber holding one past K equals JAX's reference body in interpret
    mode, which drops both (the sparse bodies do not take such operands)."""
    from test_torch_kernels import with_bad_id

    a, b, ja, ta, jb, tb = operands((256, 256, 256), 0.3, dtype)
    ja, ta = with_bad_id(ja, ta, where)
    jb, tb = with_bad_id(jb, tb, where)
    want = jops.spgemm_gustavson(ja, jb, interpret=True, method="reference")
    got = tgust.spgemm_gustavson_plain(ta, tb)
    assert got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, dtype)
    assert_close(tops.spgemm_gustavson(ta, tb, method="reference",
                                       device="cpu"), want, dtype)
