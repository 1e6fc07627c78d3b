"""The port's stream executor (``repro_torch.core.stream_exec``) against the
JAX package's sharded executor (``repro.core.sharded_exec``) and against
the port's own sequential path.

On the CPU (``StreamMesh(n, device="cpu")``) the lanes run in turn with
the card's lane mapping, so the streamed result must be the same bits as
the sequential one, for every ``pipeline_depth`` and ``shard_operands``
case run here, and within ``tests/test_kernels.py``'s tolerances of JAX's
sequential ``execute_many_kernel_schedule`` (kernels in interpret mode).
The lane mapping (``cluster_submeshes``, ``device_for_partition``), the
host capacities and the timeline folding are held to JAX's value for
value.
"""
import json
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import costmodel as jcm
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import sharded_exec as jse
from repro.core import workloads as jwl
from repro_torch import obs as tobs
from repro_torch.core import costmodel as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import hetero_matmul as thm
from repro_torch.core import scheduler as tsched
from repro_torch.core import stream_exec as tse
from repro_torch.core import workloads as twl
from repro_torch.core.stream_exec import StreamMesh

# ``repro.core`` re-exports a function named like its executor module.
jhm = sys.modules["repro.core.hetero_matmul"]

JD, TD = jcm.DataflowClass, tcm.DataflowClass
CPU8 = lambda: StreamMesh(8, device="cpu")  # noqa: E731


def small5(pkg_cm, cls_enum):
    """``tests/test_sharded_exec.py``'s five 64-PE clusters."""
    return pkg_cm.AcceleratorConfig(
        "aespa_small",
        tuple(pkg_cm.basic_cluster(c, 64) for c in (
            cls_enum.GEMM, cls_enum.SPMM, cls_enum.SPGEMM_INNER,
            cls_enum.SPGEMM_OUTER, cls_enum.SPGEMM_GUSTAVSON)),
        math.inf)


def tiny_pe(pkg_cm, cls_enum):
    """One large cluster beside two 1-PE ones: the proportional split
    rounds the small ones to empty spans, which the mapping repairs."""
    return pkg_cm.AcceleratorConfig(
        "tiny_pe",
        (pkg_cm.basic_cluster(cls_enum.GEMM, 4096),
         pkg_cm.basic_cluster(cls_enum.SPMM, 1),
         pkg_cm.basic_cluster(cls_enum.SPGEMM_OUTER, 1)),
        math.inf)


def config_pair(name):
    if name == "aespa_equal4":
        return jdse.aespa_equal4(), tdse.aespa_equal4()
    if name == "aespa_opt":
        return jdse.aespa_opt(), tdse.aespa_opt()
    return tiny_pe(jcm, JD), tiny_pe(tcm, TD)


# Mixed shapes and sparsities with a dense straggler that ``optimized``
# K-splits across clusters (tests/test_sharded_exec.py's suite).
SPECS = [(96, 96, 96, 1.0, 1.0), (64, 80, 48, 0.1, 1.0),
         (48, 64, 64, 0.05, 0.05), (32, 32, 96, 0.5, 0.3)]


def straggler_suite(seed=0):
    rng = np.random.default_rng(seed)
    pairs, jtasks = [], []
    for i, (m, k, n, dmk, dkn) in enumerate(SPECS):
        a = rng.standard_normal((m, k)) * (rng.random((m, k)) < dmk)
        b = rng.standard_normal((k, n)) * (rng.random((k, n)) < dkn)
        pairs.append((a.astype(np.float32), b.astype(np.float32)))
        jtasks.append(jwl.Workload(f"t{i}", "parity", m, k, n, dmk, dkn))
    return pairs, jtasks


def twin(jw):
    return twl.Workload(jw.name, jw.application, jw.m, jw.k, jw.n, jw.d_mk,
                        jw.d_kn)


def torch_pairs(pairs, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
            for a, b in pairs]


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32)


def tol(dtype, want):
    if dtype == "bfloat16":
        # K-split partials round to bf16 before merging: a few bf16 ULPs of
        # the largest partial (tests/test_policies.py's bound).
        return dict(rtol=3e-2,
                    atol=2e-2 + 4 * 2.0 ** -8 * float(np.abs(want).max()))
    return dict(rtol=1e-4, atol=1e-4)


def same_bits(xs, ys):
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(xs, ys))


# ------------------------------------------------------------ lane mapping
@pytest.mark.parametrize("case", ["aespa_equal4", "aespa_opt", "tiny_pe"])
@pytest.mark.parametrize("n_lanes", range(1, 17))
def test_cluster_submeshes_and_lane_rule_match_jax(case, n_lanes):
    jcfg, tcfg = config_pair(case)
    if n_lanes < len(jcfg.clusters):
        with pytest.raises(ValueError, match="clusters onto"):
            jhm.cluster_submeshes(n_lanes, jcfg)
        with pytest.raises(ValueError, match="clusters onto"):
            thm.cluster_submeshes(n_lanes, tcfg)
        return
    spans = thm.cluster_submeshes(n_lanes, tcfg)
    assert spans == jhm.cluster_submeshes(n_lanes, jcfg)
    assert [lo for _, lo, _ in spans] == [0] + [hi for _, _, hi in spans[:-1]]
    assert spans[-1][2] == n_lanes and all(hi > lo for _, lo, hi in spans)
    # 40 dispatches in a fixed cluster order land on the same lanes.
    order = [i % len(spans) for i in range(7 * len(spans))][::-1]
    jc, tc = {}, {}
    assert ([tse.device_for_partition(spans, tc, c) for c in order]
            == [jse.device_for_partition(spans, jc, c) for c in order])
    assert tc == jc


# ---------------------------------------------------------- host capacities
@pytest.mark.parametrize("seed", range(6))
def test_host_capacities_match_jax(seed):
    """Random partitions of random operands, every class and orientation:
    the same slices and the same bucketed capacities, and the same raise
    when no partition exists to slice."""
    rng = np.random.default_rng(seed)
    m, k, n = (int(x) for x in rng.integers(20, 90, size=3))
    density = [0.02, 0.2, 1.0][seed % 3]
    a = (rng.standard_normal((m, k)) * (rng.random((m, k)) < density)
         ).astype(np.float32)
    b = (rng.standard_normal((k, n)) * (rng.random((k, n)) < 0.3)
         ).astype(np.float32)
    parts_j, parts_t = [], []
    for cls in list(JD):
        for mirror in (False, True):
            if mirror and cls != JD.SPMM:
                continue
            m0, k0, n0 = (int(rng.integers(0, d // 2)) for d in (m, k, n))
            m1, k1, n1 = (int(rng.integers(d // 2 + 1, d + 1))
                          for d in (m, k, n))
            r = (m0, m1, k0, k1, n0, n1)
            parts_j.append(jsched.Partition(jsched.Region(*r), cls, 0,
                                            mirror))
            parts_t.append(tsched.Partition(tsched.Region(*r), TD(cls.value),
                                            0, mirror))
    want = jse._host_capacities(parts_j, a, b)
    got = tse._host_capacities(parts_t, a, b)
    assert [caps for *_, caps in got] == [caps for *_, caps in want]
    for (_, sa, sb, _), (_, wa, wb, _) in zip(got, want):
        np.testing.assert_array_equal(sa.numpy(), wa)
        np.testing.assert_array_equal(sb.numpy(), wb)
    got_bf16 = tse._host_capacities(parts_t, torch.from_numpy(a).bfloat16(),
                                    torch.from_numpy(b).bfloat16())
    assert [c for *_, c in got_bf16] == [c for *_, c in want]


# ------------------------------------------------------- timeline folding
def timelines(pkg):
    return [pkg.BatchTimeline(0, 2, 0.0, 0.5,
                              (pkg.SpanTiming(0, 0, 2, 0.01, 0.25),
                               pkg.SpanTiming(1, 2, 3, 0.02, 0.40),
                               pkg.SpanTiming(2, 3, 4, 0.3, 0.3))),
            pkg.BatchTimeline(1, 1, 0.45, 0.9,
                              (pkg.SpanTiming(0, 0, 2, 0.5, 0.75),
                               pkg.SpanTiming(1, 2, 3, 0.6, 0.55),
                               pkg.SpanTiming(7, 3, 4, 0.6, 0.8))),
            pkg.BatchTimeline(2, 0, 0.95, 0.96)]


@pytest.mark.parametrize("n_clusters", [1, 3, 8])
def test_aggregate_timelines_and_json_match_jax(n_clusters):
    tl_t, tl_j = timelines(tse), timelines(jse)
    assert (tse.aggregate_timelines(tl_t, n_clusters)
            == jse.aggregate_timelines(tl_j, n_clusters))
    assert ([t.to_json() for t in tl_t] == [t.to_json() for t in tl_j])
    assert tse.aggregate_timelines([], n_clusters) == \
        jse.aggregate_timelines([], n_clusters)


def test_trace_batch_timeline_matches_jax():
    """The measured re-emission lands on the same rows with the same
    events in both tracers (each mapped onto its own epoch)."""
    events = []
    for obs_mod, se in ((tobs, tse), (jobs, jse)):
        obs_mod.TRACE.reset()
        prev = obs_mod.enable()
        try:
            for tl in timelines(se):
                se.trace_batch_timeline(tl, obs_mod.TRACE._epoch + 2.0)
        finally:
            obs_mod.enable(prev)
        events.append(obs_mod.TRACE.chrome_trace())
        obs_mod.TRACE.reset()
    assert events[0] == events[1]


# --------------------------------------------- streamed == sequential path
@pytest.fixture(scope="module")
def straggler():
    """The straggler suite scheduled under ``optimized`` on five 64-PE
    clusters in both packages, and JAX's sequential outputs per dtype."""
    pairs, jtasks = straggler_suite(0)
    jms = jsched.schedule_many_kernels(small5(jcm, JD), jtasks,
                                       policy="optimized")
    tms = tsched.schedule_many_kernels(small5(tcm, TD),
                                       [twin(w) for w in jtasks],
                                       policy="optimized")
    split = [a for a in tms.assignments if a.split]
    assert split and len({pp.partition.cluster
                          for pp in split[0].placed}) > 1
    assert len({(pp.partition.region.k0, pp.partition.region.k1)
                for pp in split[0].placed}) > 1
    jax_out = {}
    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        jax_out[dtype] = [as_np(x) for x in jhm.execute_many_kernel_schedule(
            [(jnp.asarray(a, jdt), jnp.asarray(b, jdt)) for a, b in pairs],
            jms, interpret=True, block=32)]
    return pairs, tms, jax_out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard_operands", [True, False])
@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_streamed_bit_equal_to_sequential(straggler, pipeline_depth,
                                          shard_operands, dtype):
    pairs, tms, jax_out = straggler
    tp = torch_pairs(pairs, dtype)
    seq = thm.execute_many_kernel_schedule(tp, tms, block=32, device="cpu")
    sink = []
    got = thm.execute_many_kernel_schedule(
        tp, tms, block=32, mesh=CPU8(), pipeline_depth=pipeline_depth,
        shard_operands=shard_operands, measure=shard_operands,
        timeline_sink=sink)
    assert same_bits(got, seq)
    assert len(sink) == pipeline_depth
    assert sum(tl.n_jobs for tl in sink) == len(pairs)
    for tl in sink:
        assert len(tl.spans) == (len(tms.config.clusters) if shard_operands
                                 else 0)
    for (a, b), g, w in zip(pairs, got, jax_out[dtype]):
        np.testing.assert_allclose(as_np(g), w, **tol(dtype, a @ b))


@pytest.mark.parametrize("policy", ["lpt", "optimized"])
def test_streamed_table_i_queue_on_aespa_opt(policy):
    """Table I, downscaled, on ``aespa_opt`` (its Gustavson cluster
    included): streamed with measured timelines, the same bits as the
    sequential path, and within tolerance of JAX's sequential path."""
    jcfg, tcfg = config_pair("aespa_opt")
    pairs, jtasks = [], []
    for i, w0 in enumerate(jwl.TABLE_I):
        a, b, (m, k, n) = jwl.synthesize(w0, seed=100 + i, max_elems=1 << 12)
        pairs.append((a, b))
        jtasks.append(jwl.Workload(w0.name, w0.application, m, k, n,
                                   w0.d_mk, w0.d_kn))
    jms = jsched.schedule_many_kernels(jcfg, jtasks, policy=policy)
    tms = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks],
                                       policy=policy)
    assert {a.cls for a in tms.assignments} >= {TD.SPGEMM_GUSTAVSON}
    seq = thm.execute_many_kernel_schedule(pairs, tms, block=32,
                                           device="cpu")
    sink = []
    got = thm.execute_many_kernel_schedule(pairs, tms, block=32,
                                           mesh=CPU8(), pipeline_depth=2,
                                           measure=True, timeline_sink=sink)
    assert same_bits(got, seq)
    busy, makespan, sequential = tse.aggregate_timelines(
        sink, len(tcfg.clusters))
    assert makespan > 0.0 and sequential == sum(busy) > 0.0
    want = jhm.execute_many_kernel_schedule(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs], jms,
        interpret=True, block=32)
    for (a, b), g, w in zip(pairs, got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=1e-4, atol=1e-4)


def test_streamed_single_kernel_and_hetero_many_matmul():
    """``execute_schedule(mesh=)`` on speech's single-kernel schedule (SpMM
    and inner over an N split, on two clusters) and
    ``hetero_many_matmul(mesh=)``: the same bits as ``mesh=None``."""
    cfg = tdse.aespa_equal4()
    w0 = twl.BY_NAME["speech"]
    a, b, (m, k, n) = twl.synthesize(w0, seed=0, max_elems=1 << 14)
    ks = tsched.schedule_single_kernel(cfg, twl.Workload(
        w0.name, w0.application, m, k, n, w0.d_mk, w0.d_kn))
    assert len({p.cluster for p in ks.partitions}) > 1
    want = thm.execute_schedule(a, b, ks, block=32, device="cpu")
    for shard in (True, False):
        got = thm.execute_schedule(a, b, ks, block=32, mesh=CPU8(),
                                   shard_operands=shard)
        assert same_bits([got], [want])
    pairs, _ = straggler_suite(3)
    outs, ms = thm.hetero_many_matmul(pairs, cfg, policy="optimized",
                                      block=32, device="cpu")
    outs2, ms2 = thm.hetero_many_matmul(pairs, cfg, policy="optimized",
                                        block=32, mesh=CPU8())
    assert ms2 == ms and same_bits(outs2, outs)


def test_streamed_float64_operands_cast_like_sequential():
    pairs, jtasks = straggler_suite(1)
    pairs64 = [(a.astype(np.float64), b.astype(np.float64))
               for a, b in pairs]
    tms = tsched.schedule_many_kernels(small5(tcm, TD),
                                       [twin(w) for w in jtasks])
    seq = thm.execute_many_kernel_schedule(pairs, tms, block=32,
                                           device="cpu")
    got = thm.execute_many_kernel_schedule(pairs64, tms, block=32,
                                           mesh=CPU8())
    assert same_bits(got, seq) and got[0].dtype == torch.float32


def test_execute_assignment_batches_stream():
    """Batches of assignments in any order run by task index; an index in
    two batches raises, as in the JAX package."""
    pairs, jtasks = straggler_suite(2)
    tms = tsched.schedule_many_kernels(small5(tcm, TD),
                                       [twin(w) for w in jtasks])
    ops_ = dict(enumerate(pairs))
    asg = list(tms.assignments)
    sink = []
    outs = thm.execute_assignment_batches(
        [asg[2:], [], asg[:2]], ops_, tms.config, block=32, mesh=CPU8(),
        pipeline_depth=3, measure=True, timeline_sink=sink)
    seq = thm.execute_assignments(asg, ops_, tms.config, block=32,
                                  device="cpu")
    assert sorted(outs) == sorted(seq)
    assert same_bits([outs[i] for i in sorted(outs)],
                     [seq[i] for i in sorted(seq)])
    assert [tl.n_jobs for tl in sink] == [len(asg) - 2, 0, 2]
    assert sink[1].spans == ()
    with pytest.raises(ValueError, match="more than one batch"):
        thm.execute_assignment_batches([asg[:1], asg[:1]], ops_, tms.config,
                                       block=32, mesh=CPU8())


# -------------------------------------------------------------- validation
def test_validations_raise_as_jax():
    pairs, jtasks = straggler_suite(0)
    jcfg, tcfg = small5(jcm, JD), small5(tcm, TD)
    jms = jsched.schedule_many_kernels(jcfg, jtasks)
    tms = tsched.schedule_many_kernels(tcfg, [twin(w) for w in jtasks])
    ops_ = dict(enumerate(pairs))
    mesh = CPU8()
    jpairs = [(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]
    cases = [
        ("pipeline_depth must be >= 1",
         lambda: jhm.execute_assignments(jms.assignments, ops_, jcfg,
                                         pipeline_depth=0),
         lambda: thm.execute_assignments(tms.assignments, ops_, tcfg,
                                         device="cpu", pipeline_depth=0)),
        ("require.? mesh=",
         lambda: jhm.execute_assignments(jms.assignments, ops_, jcfg,
                                         pipeline_depth=2),
         lambda: thm.execute_assignments(tms.assignments, ops_, tcfg,
                                         device="cpu", pipeline_depth=2)),
        ("requires mesh",
         lambda: jhm.execute_assignment_batches([jms.assignments], ops_,
                                                jcfg),
         lambda: thm.execute_assignment_batches([tms.assignments], ops_,
                                                tcfg)),
        ("pipeline_depth must be >= 1",
         lambda: jse.execute_job_batches_sharded([], jcfg, None,
                                                 pipeline_depth=0),
         lambda: tse.execute_job_batches_streamed([], tcfg, mesh,
                                                  pipeline_depth=0)),
        ("measure=True requires shard_operands=True",
         lambda: jse.execute_job_batches_sharded([], jcfg, None,
                                                 shard_operands=False,
                                                 measure=True),
         lambda: tse.execute_job_batches_streamed([], tcfg, mesh,
                                                  shard_operands=False,
                                                  measure=True)),
        ("cost_sink requires the sequential executor",
         lambda: jhm.execute_schedule(*jpairs[0], jsched.schedule_single_kernel(
             jcfg, jtasks[0]), mesh=object(), cost_sink=[]),
         lambda: thm.execute_schedule(*pairs[0], tsched.schedule_single_kernel(
             tcfg, twin(jtasks[0])), mesh=mesh, cost_sink=[])),
        ("clusters onto",
         lambda: jhm.cluster_submeshes(2, jcfg),
         lambda: tse.execute_jobs_streamed(
             [(*pairs[0], [tms.assignments[0].placed[0].partition])], tcfg,
             StreamMesh(2, device="cpu"))),
    ]
    for match, j_call, t_call in cases:
        with pytest.raises(ValueError, match=match):
            j_call()
        with pytest.raises(ValueError, match=match):
            t_call()
    # A partition on a cluster the config lacks, in both executors.
    bad = tsched.Partition(tsched.Region(0, 8, 0, 8, 0, 8), TD.GEMM, 9)
    with pytest.raises(ValueError, match="cluster 9"):
        tse.execute_jobs_streamed([(*pairs[0], [bad])], tcfg, mesh)
    # The port's own: measure without a mesh, a mesh on another device,
    # a mesh without lanes.
    with pytest.raises(ValueError, match="require mesh"):
        thm.execute_many_kernel_schedule(pairs, tms, device="cpu",
                                         measure=True)
    with pytest.raises(ValueError, match="requires mesh"):
        thm.execute_schedule(*pairs[0], tsched.schedule_single_kernel(
            tcfg, twin(jtasks[0])), device="cpu", measure=True)
    with pytest.raises(ValueError, match="mesh= is on"):
        thm.execute_many_kernel_schedule(pairs, tms, device="cuda",
                                         mesh=mesh)
    with pytest.raises(ValueError, match="lane"):
        StreamMesh(0, device="cpu")
    assert tse.execute_jobs_streamed([], tcfg, mesh) == []


def test_stream_mesh_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: StreamMesh() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamMesh(8)
    m = StreamMesh(3, device="cpu")
    assert m.n_lanes == 3 and m.device == torch.device("cpu")
    assert m.streams == (None, None, None)


def test_live_tracing_records_executor_events_and_pipeline_gauge():
    """With the port's tracing on, a measured streamed run records the
    dispatch/retire spans and the in-flight counter on the host rows and
    one measured span per cluster per batch; outputs do not change."""
    pairs, jtasks = straggler_suite(0)
    tms = tsched.schedule_many_kernels(small5(tcm, TD),
                                       [twin(w) for w in jtasks])
    plain = thm.execute_many_kernel_schedule(pairs, tms, block=32,
                                             mesh=CPU8(), pipeline_depth=2)
    tobs.TRACE.reset()
    prev = tobs.enable()
    try:
        got = thm.execute_many_kernel_schedule(
            pairs, tms, block=32, mesh=CPU8(), pipeline_depth=2,
            measure=True)
    finally:
        tobs.enable(prev)
    evs = tobs.TRACE.events()
    tobs.TRACE.reset()
    assert same_bits(got, plain)
    names = {e["name"] for e in evs}
    assert {"dispatch", "retire", "in_flight", "batch0", "batch1"} <= names
    assert {e["pid"] for e in evs if e.get("cat") == "executor"} == {
        tobs.PID_HOST}
    sub = [e for e in evs if e.get("cat") == "submesh"]
    assert len(sub) == 2 * len(tms.config.clusters)
    assert tobs.METRICS.snapshot()["gauges"][
        "executor.pipeline.in_flight"] == 0.0
    json.dumps(tobs.TRACE.chrome_trace())
