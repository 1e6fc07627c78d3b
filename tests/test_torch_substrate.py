"""The port's training substrate (``repro_torch.train``, ``optim``,
``data``, ``checkpoint``, ``runtime``) against the JAX package's:
``tests/test_substrate.py``'s checks, each run through both packages on the
same numpy inputs and, for the train steps, the same initial state (JAX's,
carried across with ``train_state_from_numpy``).

Tolerances: the chunked loss within rtol 1e-5 (``test_substrate.py``'s);
AdamW, ``lr_at`` and the compressors within rtol 1e-6, a few float32
ulps (XLA's ``cos`` lands up to 4 ulps from ATen's on these schedules); the data pipeline, the checkpoints and the driver's replays bit
for bit; a train step's loss within rtol 1e-5 and its first moments
within 1e-4 of their largest magnitude (float32 grads through the two
packages' reductions); grad accumulation at ``test_substrate.py``'s rtol
1e-3, atol 1e-6.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro.data as jdata
import repro.optim as jopt
import repro.train as jtrain
import repro_torch.checkpoint as tck
import repro_torch.data as tdata
import repro_torch.optim as topt
import repro_torch.train as ttrain
from repro.configs import get_reduced as jreduced
from repro.models import build as jbuild
from repro.runtime import DriverConfig as JDriverConfig
from repro.runtime import TrainDriver as JTrainDriver
from repro.train.step import init_train_state as jinit_train_state
from repro_torch.common.pytree import tree_leaves_with_path, tree_map
from repro_torch.configs import get_reduced as treduced
from repro_torch.models import build as tbuild
from repro_torch.runtime import DriverConfig, TrainDriver

CPU = torch.device("cpu")
ULPS = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def same_leaves(jtree, ttree, rtol=0.0, atol=0.0):
    """Every leaf of the port's tree against JAX's at the same key path."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree_leaves_with_path(ttree)
    assert [tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)
            for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(p))


# ------------------------------------------------------------------- loss
def test_chunked_xent_matches_jax():
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 20, 16, 64
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :3] = -1  # masked prefix

    def jfn(h):
        return jnp.einsum("bcd,vd->bcv", h, jnp.asarray(table))

    def tfn(h):
        return torch.einsum("bcd,vd->bcv", h, t(table))

    jloss = lambda h: jtrain.xent_chunked(h, jnp.asarray(labels), jfn,  # noqa: E731
                                          chunk=7)[0]
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(hidden))
    th = t(hidden).requires_grad_()
    got, count = ttrain.xent_chunked(th, t(labels), tfn, chunk=7)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(got), float(ttrain.full_xent(tfn(t(hidden)), t(labels))),
        rtol=1e-5)
    assert int(count) == int((labels >= 0).sum())
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- optimizer
def test_adamw_trajectory_matches_jax():
    """20 clipped steps on a quadratic with weight decay: each step's
    params, moments, lr and grad norm equal to JAX's; a 2-D leaf, a
    stacked (2, 4) norm-like leaf (decayed, ndim 2) and a vector (not)."""
    jcfg = jopt.AdamWConfig(lr=0.1, warmup_steps=3, total_steps=20,
                            weight_decay=0.1, grad_clip=0.5,
                            mixed_precision=False)
    tcfg = topt.AdamWConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})
    rng = np.random.default_rng(4)
    init = {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "norms": np.ones((2, 4), np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}
    jp = {k: jnp.asarray(a) for k, a in init.items()}
    tp = {k: t(a) for k, a in init.items()}
    js, ts = jopt.init_state(jcfg, jp), topt.init_state(tcfg, tp)

    def jloss(p):
        return sum(jnp.sum(jnp.square(x - 0.3)) for x in p.values())

    l0 = float(jloss(jp))
    for _ in range(20):
        jg = jax.grad(jloss)(jp)
        tg = {k: t(np.asarray(g)) for k, g in jg.items()}
        jp, js, jm = jopt.apply_updates(jcfg, jp, jg, js)
        tp, ts, tm = topt.apply_updates(tcfg, tp, tg, ts)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=ULPS)
        same_leaves(jp, tp, rtol=ULPS, atol=1e-7)
        same_leaves(js, ts, rtol=ULPS, atol=1e-7)
    assert float(jloss({k: jnp.asarray(x.numpy()) for k, x in tp.items()})
                 ) < l0 * 0.5
    assert int(ts["step"]) == 20 and ts["step"].dtype == torch.int32


def test_lr_schedule_matches_jax_at_every_step():
    for kw in ({"lr": 1.0, "warmup_steps": 10, "total_steps": 110,
                "min_lr_ratio": 0.1},
               {"lr": 3e-4, "warmup_steps": 2, "total_steps": 8},
               {"warmup_steps": 0, "total_steps": 5}):
        jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        steps = np.arange(0, tcfg.total_steps + 3, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jcfg, s))(
            jnp.asarray(steps)))
        got = topt.lr_at(tcfg, t(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=ULPS)
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                           min_lr_ratio=0.1)
    assert float(topt.lr_at(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(topt.lr_at(cfg, torch.tensor(10))) == pytest.approx(
        1.0, rel=1e-2)
    assert float(topt.lr_at(cfg, torch.tensor(110))) == pytest.approx(
        0.1, rel=1e-2)


def test_mixed_precision_master_copies_match_jax():
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=0, mixed_precision=True)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0, mixed_precision=True)
    jp = {"w": jnp.ones((8, 8), jnp.bfloat16)}
    tp = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    jg = {"w": jnp.full((8, 8), 1e-4, jnp.bfloat16)}
    tg = {"w": torch.full((8, 8), 1e-4, dtype=torch.bfloat16)}
    assert float(tg["w"][0, 0]) == float(jg["w"][0, 0])
    js, ts = jopt.init_state(jcfg, jp), topt.init_state(tcfg, tp)
    assert ts["master"]["w"].dtype == torch.float32
    for _ in range(3):
        jp, js, _ = jopt.apply_updates(jcfg, jp, jg, js)
        tp, ts, _ = topt.apply_updates(tcfg, tp, tg, ts)
    assert tp["w"].dtype == torch.bfloat16
    assert ts["master"]["w"].dtype == torch.float32
    # the master accumulates updates too small for bf16 resolution
    assert float((ts["master"]["w"] - 1.0).abs().max()) > 0
    same_leaves(js, ts, rtol=ULPS)
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_matches_jax(kind):
    """50 steps of error feedback: each step's sent grads and residual
    equal to JAX's, and sum(sent) ≈ sum(true grads) as the JAX test
    holds."""
    jcomp = jopt.Compressor(kind=kind, topk_ratio=0.25)
    tcomp = topt.Compressor(kind=kind, topk_ratio=0.25)
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((32, 32)) * 1e-3).astype(np.float32)
    jerr = jopt.init_error({"w": jnp.asarray(g)})
    terr = topt.init_error({"w": t(g)})
    total = np.zeros_like(g)
    for _ in range(50):
        jsent, jerr = jopt.compress_with_feedback(jcomp, {"w": jnp.asarray(g)},
                                                  jerr)
        tsent, terr = topt.compress_with_feedback(tcomp, {"w": t(g)}, terr)
        same_leaves(jsent, tsent, rtol=ULPS, atol=1e-12)
        same_leaves(jerr, terr, rtol=ULPS, atol=1e-12)
        total += tsent["w"].numpy()
    np.testing.assert_allclose(total / 50, g, atol=2e-4)


def test_compression_rounding_and_ties_match_jax():
    """int8 rounds half to even (``jnp.round``); top-k keeps every entry
    tied with the k-th largest magnitude (k = 2 of 8 here: the threshold is
    3, and all three 3s tie with it)."""
    halves = np.array([[127.0, 2.5, 3.5, -2.5, 0.5, -1.5]], np.float32)
    ties = np.array([[4.0, 3.0, -3.0, 3.0, 1.0, 0.0, 0.5, 0.0]], np.float32)
    got = {}
    for kind, g in (("int8", halves), ("topk", ties)):
        jcomp = jopt.Compressor(kind=kind, topk_ratio=0.25)
        tcomp = topt.Compressor(kind=kind, topk_ratio=0.25)
        jsent, jerr = jopt.compress_with_feedback(
            jcomp, {"w": jnp.asarray(g)},
            jopt.init_error({"w": jnp.asarray(g)}))
        tsent, terr = topt.compress_with_feedback(
            tcomp, {"w": t(g)}, topt.init_error({"w": t(g)}))
        same_leaves(jsent, tsent)
        same_leaves(jerr, terr)
        got[kind] = tsent["w"].numpy()[0]
    np.testing.assert_array_equal(got["int8"], [127, 2, 4, -2, 0, -2])
    np.testing.assert_array_equal(got["topk"], [4, 3, -3, 3, 0, 0, 0, 0])


# ------------------------------------------------------------------- data
def test_data_pipeline_bit_equal_to_jax():
    base = dict(vocab_size=100, seq_len=16, global_batch=8, n_hosts=2)
    for host in (0, 1):
        jd = jdata.TokenDataset(jdata.DataConfig(**base, host_id=host))
        td = tdata.TokenDataset(tdata.DataConfig(**base, host_id=host))
        for step in (0, 3, 17):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            assert sorted(tb) == ["labels", "tokens"]
            for k in jb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
    d0 = tdata.TokenDataset(tdata.DataConfig(**base, host_id=0))
    d1 = tdata.TokenDataset(tdata.DataConfig(**base, host_id=1))
    assert not np.array_equal(d0.batch_at(3)["tokens"],
                              d1.batch_at(3)["tokens"])     # disjoint
    assert d0.batch_at(3)["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(d0.batch_at(0)["labels"][:, :-1],
                                  d0.batch_at(0)["tokens"][:, 1:])
    it = d0.iterate(5)
    loader = tdata.PrefetchLoader(d0, start_step=5)
    try:
        for _ in range(3):
            want = next(it)
            got = next(loader)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_data_file_backend_bit_equal_to_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(10_000, dtype=np.int32).tofile(path)
    kw = dict(vocab_size=10_000, seq_len=8, global_batch=4,
              backend="file", path=path)
    jd = jdata.TokenDataset(jdata.DataConfig(**kw))
    td = tdata.TokenDataset(tdata.DataConfig(**kw))
    for step in (0, 1, 9):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(td.batch_at(step)[k],
                                          jd.batch_at(step)[k])
    # windows are contiguous slices of the file
    assert (np.diff(td.batch_at(0)["tokens"], axis=1) == 1).all()


# ------------------------------------------------------------- checkpoint
def _npz(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}.npz")) as d:
        return {k: d[k] for k in d.files}


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    """A float32 state saved by the port: the same keys, arrays and
    manifest as JAX's save of the same state, and JAX's ``restore`` reads
    it."""
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    jstate = {"params": {"w": jnp.asarray(w), "tail": [jnp.ones(2)]},
              "opt": {"step": jnp.asarray(7, jnp.int32)}, "error": {}}
    tstate = {"params": {"w": t(w), "tail": [torch.ones(2)]},
              "opt": {"step": torch.tensor(7, dtype=torch.int32)},
              "error": {}}
    jck.save(str(tmp_path / "j"), jstate, step=7, extra={"note": 1})
    tck.save(str(tmp_path / "t"), tstate, step=7, extra={"note": 1})
    assert tck.latest_step(str(tmp_path / "t")) == 7
    for name in ("manifest.json",):
        assert (json.loads((tmp_path / "t" / name).read_text())
                == json.loads((tmp_path / "j" / name).read_text()))
    jn, tn = _npz(tmp_path / "j", 7), _npz(tmp_path / "t", 7)
    assert sorted(tn) == sorted(jn) == ["opt/step", "params/tail/0",
                                        "params/w"]
    for k in jn:
        assert tn[k].dtype == jn[k].dtype and tn[k].shape == jn[k].shape
        np.testing.assert_array_equal(tn[k], jn[k])
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    restored, manifest = jck.restore(str(tmp_path / "t"), like)
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]), w)
    assert int(restored["opt"]["step"]) == 7 and manifest["step"] == 7


def test_checkpoint_written_by_jax_restores_in_the_port_bf16(tmp_path):
    """JAX writes a bf16 leaf as 2-byte voids, which its own ``restore``
    cannot cast (a known difference of the reference); the port reads it
    by its bits, and its own bf16 round trip is bit-exact."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                         "s": jnp.asarray(w[0])},
              "opt": {"step": jnp.asarray(3, jnp.int32)}}
    jck.save(str(tmp_path), jstate, step=3)
    assert _npz(tmp_path, 3)["params/w"].dtype == np.dtype("V2")
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    with pytest.raises(ValueError, match="No cast function"):
        jck.restore(str(tmp_path), like)
    tlike = {"params": {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                        "s": torch.zeros(5)},
             "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, manifest = tck.restore(str(tmp_path), tlike, device="cpu")
    assert manifest["step"] == 3 and got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["w"].view(torch.int16).numpy(),
        np.asarray(jstate["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(got["params"]["s"].numpy(), w[0])
    assert int(got["opt"]["step"]) == 3

    tck.save(str(tmp_path / "t"), got, step=4)
    assert _npz(tmp_path / "t", 4)["params/w"].dtype == np.dtype("V2")
    again, _ = tck.restore(str(tmp_path / "t"), tlike, device="cpu")
    assert torch.equal(again["params"]["w"].view(torch.int16),
                       got["params"]["w"].view(torch.int16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.restore(str(tmp_path / "t"), tlike)


def test_async_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """An in-place write to the state right after ``save`` returns does
    not reach the file."""
    state = {"w": torch.arange(4.0), "b": torch.ones(3, dtype=torch.bfloat16)}
    ck = tck.AsyncCheckpointer(str(tmp_path))
    ck.save(state, 1)
    state["w"].add_(100.0)
    state["b"].mul_(3)
    ck.wait()
    got, _ = tck.restore(str(tmp_path), state, device="cpu")
    assert torch.equal(got["w"], torch.arange(4.0))
    assert torch.equal(got["b"], torch.ones(3, dtype=torch.bfloat16))


# ------------------------------------------------------- end-to-end train
def _tcfgs(microbatches=1, warmup=2):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=50,
              mixed_precision=False)
    return (jtrain.TrainConfig(optimizer=jopt.AdamWConfig(**kw),
                               microbatches=microbatches, xent_chunk=8),
            ttrain.TrainConfig(optimizer=topt.AdamWConfig(**kw),
                               microbatches=microbatches, xent_chunk=8))


@pytest.fixture(scope="module")
def tiny_setup():
    """JAX's and the port's qwen1.5-0.5b (reduced) from JAX's initial
    state, their steps and the dataset of ``test_substrate.py``."""
    jm = jbuild(jreduced("qwen1.5-0.5b"))
    tm = tbuild(treduced("qwen1.5-0.5b"))
    jt, tt = _tcfgs()
    js = jinit_train_state(jm, jt, jax.random.PRNGKey(0))
    ts = ttrain.train_state_from_numpy(jax.tree.map(np.asarray, js), tm.cfg,
                                       device="cpu")
    ds = tdata.TokenDataset(tdata.DataConfig(vocab_size=tm.cfg.vocab_size,
                                             seq_len=16, global_batch=4))
    return (jm, jt, js, jax.jit(jtrain.make_train_step(jm, None, jt)),
            tm, tt, ts, ttrain.make_train_step(tm, None, tt), ds)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_loss_decreases_as_in_jax(tiny_setup):
    jm, jt, js, jstep, tm, tt, ts, tstep, ds = tiny_setup
    batch = ds.batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, jlosses = [], []
    for _ in range(8):   # overfit a single batch
        ts, m = tstep(ts, _tb(batch))
        js, jmet = jstep(js, jb)
        losses.append(float(m["loss"]))
        jlosses.append(float(jmet["loss"]))
        assert all(np.isfinite(float(v)) for v in m.values())
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_grad_accumulation_matches_full_batch_and_jax():
    jm = jbuild(jreduced("qwen1.5-0.5b"))
    tm = tbuild(treduced("qwen1.5-0.5b"))
    (jfull, tfull), (jacc, tacc) = _tcfgs(1, 0), _tcfgs(2, 0)
    s0 = jinit_train_state(jm, jfull, jax.random.PRNGKey(1))
    t0 = ttrain.train_state_from_numpy(jax.tree.map(np.asarray, s0), tm.cfg,
                                       device="cpu")
    ds = tdata.TokenDataset(tdata.DataConfig(vocab_size=tm.cfg.vocab_size,
                                             seq_len=16, global_batch=4))
    batch = ds.batch_at(0)
    s_full, _ = ttrain.make_train_step(tm, None, tfull)(t0, _tb(batch))
    s_acc, m_acc = ttrain.make_train_step(tm, None, tacc)(t0, _tb(batch))
    j_acc, jm_acc = jax.jit(jtrain.make_train_step(jm, None, jacc))(
        s0, {k: jnp.asarray(v) for k, v in batch.items()})
    # First moments (linear in the gradients), as test_substrate.py holds
    for (_, a), (_, b) in zip(tree_leaves_with_path(s_full["opt"]["m"]),
                              tree_leaves_with_path(s_acc["opt"]["m"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-6)
    for k in ("nll", "aux", "tokens", "loss"):
        np.testing.assert_allclose(float(m_acc[k]), float(jm_acc[k]),
                                   rtol=1e-5)
    assert float(m_acc["aux"]) == float(m_acc["tokens"]) == 0.0
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_acc["opt"]["m"])]
    for a, (_, b) in zip(jl, tree_leaves_with_path(s_acc["opt"]["m"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


# ------------------------------------------------------------------ driver
def _driver(ckdir, tstep, ds, total, every):
    return TrainDriver(DriverConfig(total_steps=total, checkpoint_every=every,
                                    checkpoint_dir=ckdir),
                       tstep, ds, to_device=_tb)


def test_driver_checkpoint_restart_with_failures(tmp_path, tiny_setup):
    jm, jt, js, jstep, tm, tt, ts, tstep, ds = tiny_setup
    d = _driver(str(tmp_path / "ck"), tstep, ds, 12, 4)
    report = d.run(ts, fail_at={6: RuntimeError("injected node failure"),
                                9: RuntimeError("injected preemption")},
                   device="cpu")
    assert report.restarts == 2
    assert tck.latest_step(str(tmp_path / "ck")) == 12
    assert report.final_metrics["loss"] > 0
    capped = _driver(str(tmp_path / "cap"), tstep, ds, 12, 4)
    capped.cfg.max_restarts = 1
    with pytest.raises(RuntimeError, match="second"):
        capped.run(ts, fail_at={2: RuntimeError("first"),
                                3: RuntimeError("second")}, device="cpu")


def test_driver_determinism_across_restart_and_with_jax(tmp_path, tiny_setup):
    """Loss at step 8 identical with and without a mid-run crash (bit for
    bit), equal to JAX's driver's within rtol 1e-5; the last checkpoint
    restores the state the run ended with."""
    jm, jt, js, jstep, tm, tt, ts, tstep, ds = tiny_setup
    before = tree_map(torch.clone, ts)
    r1 = _driver(str(tmp_path / "a"), tstep, ds, 8, 2).run(
        ts, fail_at={5: RuntimeError("boom")}, device="cpu")
    d2 = _driver(str(tmp_path / "b"), tstep, ds, 8, 2)
    r2 = d2.run(ts, device="cpu")
    assert r1.restarts == 1 and r2.restarts == 0
    assert r1.final_metrics == r2.final_metrics
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             ts, before)   # the caller's state is not written
    jd = JTrainDriver(JDriverConfig(total_steps=8, checkpoint_every=2,
                                    checkpoint_dir=str(tmp_path / "j")),
                      jstep, ds,
                      to_device=lambda b: {k: jnp.asarray(v)
                                           for k, v in b.items()})
    jr = jd.run(js, fail_at={5: RuntimeError("boom")})
    np.testing.assert_allclose(r1.final_metrics["loss"],
                               jr.final_metrics["loss"], rtol=1e-5)
    # the driver's last checkpoint holds the state of step 8
    final, _ = tck.restore(str(tmp_path / "b"), ts, device="cpu")
    replay = ts
    for step in range(8):
        replay, _ = tstep(replay, _tb(ds.batch_at(step)))
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             final, replay)
