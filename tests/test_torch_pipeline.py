"""The PyTorch port's single-kernel slice against the JAX package: the
scheduler's partitions and reports, configs carried over as JSON, the
executor on the same schedules and operands, the device default, and the
rule that the port imports neither JAX nor ``repro``.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import workloads as jwl
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twl
from repro_torch.core.hetero_matmul import (
    execute_assignments,
    execute_many_kernel_schedule,
    execute_schedule,
    hetero_many_matmul,
    hetero_matmul,
)
from repro_torch.formats import ell as tell
from repro_torch.formats.taxonomy import DataflowClass as TClass
from repro_torch.kernels import ops as tops

# ``repro.core`` re-exports a function named like its executor module.
jhm = sys.modules["repro.core.hetero_matmul"]

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = [w.name for w in jwl.TABLE_I]
CONFIGS = {
    "aespa_equal4": (jdse.aespa_equal4, tdse.aespa_equal4),
    "aespa_opt": (jdse.aespa_opt, tdse.aespa_opt),
    "homog_spmm": (lambda: jcm.homogeneous(jcm.DataflowClass.SPMM),
                   lambda: tcm.homogeneous(TClass.SPMM)),
    "homog_outer": (lambda: jcm.homogeneous(jcm.DataflowClass.SPGEMM_OUTER),
                    lambda: tcm.homogeneous(TClass.SPGEMM_OUTER)),
}


def partitions(schedule):
    return [(region_tuple(p.region), p.cls.value, p.cluster, p.mirror)
            for p in schedule.partitions]


def region_tuple(r):
    return (r.m0, r.m1, r.k0, r.k1, r.n0, r.n1)


def assert_same_schedule(js, ts):
    assert partitions(ts) == partitions(js)
    assert ts.report.runtime_s == js.report.runtime_s
    assert ts.report.energy_pj == js.report.energy_pj


def workload_pair(name, dims=None):
    jw = jwl.BY_NAME[name]
    tw = twl.BY_NAME[name]
    if dims is not None:
        jw = jwl.Workload(jw.name, jw.application, *dims, jw.d_mk, jw.d_kn)
        tw = twl.Workload(tw.name, tw.application, *dims, tw.d_mk, tw.d_kn)
    return jw, tw


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_jax(name, config):
    jmake, tmake = CONFIGS[config]
    jw, tw = workload_pair(name)
    assert tw == twl.Workload(*(getattr(jw, f) for f in (
        "name", "application", "m", "k", "n", "d_mk", "d_kn")))
    assert_same_schedule(jsched.schedule_single_kernel(jmake(), jw),
                         tsched.schedule_single_kernel(tmake(), tw))


@pytest.mark.parametrize("make", [
    lambda: jdse.aespa_equal5(),
    lambda: jcm.homogeneous_hybrid(),
    lambda: jcm.aespa_from_fractions(
        {jcm.DataflowClass.SPMM: 0.6, jcm.DataflowClass.SPGEMM_OUTER: 0.4},
        name="inf_bw", hbm_bw=float("inf"), scratchpad_bytes=4 << 20),
], ids=["aespa_equal5", "homog_hybrid", "inf_bw"])
def test_config_carried_as_json(make):
    """A config from ``repro``'s ``config_to_json`` (for instance a DSE
    result) loads into the port and schedules every workload the same."""
    jcfg = make()
    tcfg = tcm.config_from_json(json.loads(json.dumps(
        jcm.config_to_json(jcfg))))
    assert tcm.config_to_json(tcfg) == jcm.config_to_json(jcfg)
    for name in NAMES:
        jw, tw = workload_pair(name)
        assert_same_schedule(jsched.schedule_single_kernel(jcfg, jw),
                             tsched.schedule_single_kernel(tcfg, tw))


def test_synthesize_gives_the_same_operands():
    for name in ("citeseer", "bibd_81_3"):
        ja, jb, jdims = jwl.synthesize(jwl.BY_NAME[name], seed=3,
                                       max_elems=1 << 14)
        ta, tb, tdims = twl.synthesize(twl.BY_NAME[name], seed=3,
                                       max_elems=1 << 14)
        assert jdims == tdims
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jb, tb)


def k_split_partitions(pkg_sched, cls_enum, m, k, n):
    """The synthetic_dense pattern, scaled down: SpMM over k[0:K/2] on
    cluster 1, outer product over k[K/2:K] on cluster 3 (aespa_equal4's
    EIE-like and OuterSPACE-like clusters)."""
    h = k // 2
    return (
        pkg_sched.Partition(pkg_sched.Region(0, m, 0, h, 0, n),
                            cls_enum.SPMM, 1),
        pkg_sched.Partition(pkg_sched.Region(0, m, h, k, 0, n),
                            cls_enum.SPGEMM_OUTER, 3),
    )


def mirrored_partitions(pkg_sched, cls_enum, m, k, n):
    """Mirrored SpMM on the top rows, plain SpMM on the rest: an M split."""
    h = m // 3
    return (
        pkg_sched.Partition(pkg_sched.Region(0, h, 0, k, 0, n),
                            cls_enum.SPMM, 1, mirror=True),
        pkg_sched.Partition(pkg_sched.Region(h, m, 0, k, 0, n),
                            cls_enum.SPMM, 1),
    )


def gustavson_split_partitions(pkg_sched, cls_enum, m, k, n):
    """aespa_opt's synthetic_dense pattern, scaled down: GEMM over
    k[0:7K/8] on cluster 0, Gustavson over k[7K/8:K] on cluster 3."""
    h = k * 7 // 8
    return (
        pkg_sched.Partition(pkg_sched.Region(0, m, 0, h, 0, n),
                            cls_enum.GEMM, 0),
        pkg_sched.Partition(pkg_sched.Region(0, m, h, k, 0, n),
                            cls_enum.SPGEMM_GUSTAVSON, 3),
    )


def hand_schedules(kind, dims, d_mk, d_kn):
    make = {"k_split": k_split_partitions,
            "mirrored": mirrored_partitions,
            "gustavson_split": gustavson_split_partitions}[kind]
    jw = jwl.Workload(kind, "test", *dims, d_mk, d_kn)
    tw = twl.Workload(kind, "test", *dims, d_mk, d_kn)
    jcfg, tcfg = jdse.aespa_equal4(), tdse.aespa_equal4()
    if kind == "gustavson_split":
        jcfg, tcfg = jdse.aespa_opt(), tdse.aespa_opt()
    jparts = make(jsched, jcm.DataflowClass, *dims)
    tparts = make(tsched, TClass, *dims)
    js = jsched.KernelSchedule(jw, jcfg, jparts,
                               jsched._evaluate(jcfg, jw, jparts))
    ts = tsched.KernelSchedule(tw, tcfg, tparts,
                               tsched._evaluate(tcfg, tw, tparts))
    return js, ts


def run_both(a, b, js, ts, block=64):
    want = np.asarray(jhm.execute_schedule(a, b, js, block=block),
                      np.float32)
    got = execute_schedule(a, b, ts, block=block, device="cpu")
    assert got.shape == (a.shape[0], b.shape[1])
    return got, want


@pytest.mark.parametrize("name,max_elems", [
    ("citeseer", 1 << 17), ("chem97ZtZ", 1 << 17), ("m3plates", 1 << 17),
    ("bibd_81_3", 1 << 18), ("journals", 1 << 14), ("speech", 1 << 15),
    ("gnmt", 1 << 17), ("transformer", 1 << 14),
])
def test_execute_schedule_matches_jax(name, max_elems):
    """Table I workloads, scaled down, on their own aespa_equal4 schedules
    (outer products, mirrored SpMM, GEMM, and SpMM beside inner SpGEMM)."""
    a, b, dims = twl.synthesize(twl.BY_NAME[name], seed=0,
                                max_elems=max_elems)
    jw, tw = workload_pair(name, dims)
    js = jsched.schedule_single_kernel(jdse.aespa_equal4(), jw)
    ts = tsched.schedule_single_kernel(tdse.aespa_equal4(), tw)
    assert_same_schedule(js, ts)
    got, want = run_both(a, b, js, ts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("name,max_elems", [
    ("citeseer", 1 << 17), ("gnmt", 1 << 14), ("gnmt", 1 << 20),
    ("speech", 1 << 21),
])
def test_execute_schedule_aespa_opt_matches_jax(name, max_elems):
    """Table I workloads, scaled down, on their own ``aespa_opt``
    schedules: Gustavson whole (citeseer, small gnmt), and K-splits whose
    Gustavson partial merges with inner SpGEMM and SpMM (gnmt, speech).
    synthetic_dense's GEMM + Gustavson split is hand-built below: the
    scheduler makes it only from 2048×2048×1024 up, where a dense f32 sum
    over K drifts past the elementwise 1e-4 in any summation order."""
    a, b, dims = twl.synthesize(twl.BY_NAME[name], seed=0,
                                max_elems=max_elems)
    jw, tw = workload_pair(name, dims)
    js = jsched.schedule_single_kernel(jdse.aespa_opt(), jw)
    ts = tsched.schedule_single_kernel(tdse.aespa_opt(), tw)
    assert_same_schedule(js, ts)
    assert TClass.SPGEMM_GUSTAVSON in {p.cls for p in ts.partitions}
    got, want = run_both(a, b, js, ts, block=128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("kind,dims,d_mk,d_kn", [
    ("k_split", (192, 256, 160), 1.0, 1.0),
    ("k_split", (150, 200, 130), 0.2, 0.1),
    ("mirrored", (200, 180, 150), 0.05, 0.3),
    ("gustavson_split", (192, 256, 160), 1.0, 1.0),
    ("gustavson_split", (150, 300, 130), 0.3, 0.2),
])
def test_hand_built_schedules_match_jax(kind, dims, d_mk, d_kn):
    """K-splits whose two partials merge into one output tile (SpMM and
    outer product, GEMM and Gustavson), and a mirrored SpMM beside a plain
    one."""
    rng = np.random.default_rng(7)
    m, k, n = dims
    a = (rng.standard_normal((m, k))
         * (rng.random((m, k)) < d_mk)).astype(np.float32)
    b = (rng.standard_normal((k, n))
         * (rng.random((k, n)) < d_kn)).astype(np.float32)
    js, ts = hand_schedules(kind, dims, d_mk, d_kn)
    assert ts.k_split == (kind != "mirrored")
    assert_same_schedule(js, ts)
    got, want = run_both(a, b, js, ts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_hetero_matmul_matches_jax():
    a, b, dims = twl.synthesize(twl.BY_NAME["chem97ZtZ"], seed=1,
                                max_elems=1 << 16)
    want, js = jhm.hetero_matmul(a, b, jdse.aespa_equal4(), block=64)
    got, ts = hetero_matmul(a, b, tdse.aespa_equal4(), block=64,
                            device="cpu")
    # The port measures exact densities; JAX's float32 means may differ in
    # the last bit, so the reports agree to rounding, the partitions exactly.
    assert partitions(ts) == partitions(js)
    assert ts.workload.d_mk == pytest.approx(js.workload.d_mk, rel=1e-6)
    assert ts.workload.d_kn == pytest.approx(js.workload.d_kn, rel=1e-6)
    assert ts.report.runtime_s == pytest.approx(js.report.runtime_s, rel=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def float64_pair(name, seed, max_elems):
    """A Table I workload's operands, scaled down, as float64 numpy (what
    ``np.random`` gives): both packages compute in float32 from them."""
    a, b, dims = twl.synthesize(twl.BY_NAME[name], seed=seed,
                                max_elems=max_elems)
    return a.astype(np.float64), b.astype(np.float64), dims


def test_execute_schedule_casts_float64_like_jax():
    """float64 operands come out float32 and equal JAX's (``jnp.asarray``
    without x64 makes them float32); before, the port kept float64, which
    no kernel takes on the card."""
    a, b, dims = float64_pair("speech", 2, 1 << 15)
    jw, tw = workload_pair("speech", dims)
    js = jsched.schedule_single_kernel(jdse.aespa_equal4(), jw)
    ts = tsched.schedule_single_kernel(tdse.aespa_equal4(), tw)
    want = jhm.execute_schedule(a, b, js, block=64)
    got = execute_schedule(a, b, ts, block=64, device="cpu")
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_hetero_matmul_casts_float64_like_jax():
    a, b, _ = float64_pair("chem97ZtZ", 3, 1 << 16)
    want, js = jhm.hetero_matmul(a, b, jdse.aespa_equal4(), block=64)
    got, ts = hetero_matmul(a, b, tdse.aespa_equal4(), block=64,
                            device="cpu")
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32
    assert partitions(ts) == partitions(js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_entry_points_default_to_the_card():
    """Without ``device`` an entry point runs on the card, and with no card
    it raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    a, b, dims = twl.synthesize(twl.BY_NAME["citeseer"], seed=0,
                                max_elems=1 << 12)
    _, tw = workload_pair("citeseer", dims)
    ts = tsched.schedule_single_kernel(tdse.aespa_equal4(), tw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_schedule(a, b, ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hetero_matmul(a, b, tdse.aespa_equal4())
    b_ell = tell.dense_to_ell(torch.from_numpy(b), 1, 8)
    a_ell = tell.dense_to_ell(torch.from_numpy(a), 0, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.spmm(torch.from_numpy(a), b_ell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.gemm(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.spgemm_inner(a_ell, b_ell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.spgemm_gustavson(tell.dense_to_ell(torch.from_numpy(a), 1, 8),
                              b_ell)
    ms = tsched.schedule_many_kernels(tdse.aespa_equal4(), [tw])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_many_kernel_schedule([(a, b)], ms)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_assignments(ms.assignments, {0: (a, b)}, ms.config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hetero_many_matmul([(a, b)], tdse.aespa_equal4())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.resolve_device()
    assert tops.resolve_device("cpu") == torch.device("cpu")

    # The LM zoo and its serving engine.
    from repro_torch.configs import get_reduced
    from repro_torch.models import build, params_from_numpy
    from repro_torch.common.pytree import tree_map
    from repro_torch.serve.engine import (
        greedy_generate,
        greedy_generate_reference,
    )

    model = build(get_reduced("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    params = model.init(device="cpu")
    tree = tree_map(lambda t: t.numpy(), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, model.cfg)
    assert params_from_numpy(tree, model.cfg, device="cpu")[
        "embed"]["tok"].device == torch.device("cpu")
    prompt = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_generate(model, params, prompt, n_steps=2, s_max=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_generate_reference(model, params, prompt, n_steps=2, s_max=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
