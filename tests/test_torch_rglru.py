"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``): the same params (JAX's, carried across
as numpy) and the same numpy inputs give the same gates, the same
recurrence from the port's doubling scan as from ``lax.associative_scan``,
the same full-sequence block with its decode state, and the same
token-by-token decode; float32 at rtol = atol = 1e-5, bfloat16 at 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import rglru as jR
from repro_torch.models import rglru as tR
from repro_torch.common.pytree import tree_map
from repro_torch.models.zoo import _tensor

ARCH = "recurrentgemma-2b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = torch.device("cpu")


def block(dtype="float32", seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=dtype)
    jp = jax.jit(lambda k: jR.init_rglru_block(k, jcfg, jcfg.param_dtype))(
        jax.random.PRNGKey(seed))
    tp = tree_map(lambda a: _tensor(np.asarray(a), CPU), jp)
    return jcfg, tcfg, jp, tp


def jit_apply(jcfg):
    """JAX's full-sequence block with its decode state, jitted."""
    return jax.jit(lambda p, x: jR.rglru_apply(p, x, jcfg, None,
                                               return_state=True))


def jit_decode(jcfg):
    """JAX's one-token update, jitted."""
    return jax.jit(lambda p, x, c: jR.rglru_decode(p, x, c, jcfg, None))


def both(a, dtype="float32"):
    """A numpy array as a JAX array and a tensor of the same values."""
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                                np.float32),
                               rtol=tol, atol=tol)


def test_gates_match_jax():
    jcfg, tcfg, jp, tp = block(seed=1)
    jx, tx = both(np.random.default_rng(1).standard_normal(
        (2, 7, jcfg.rglru_width)))
    (ja, jg), (ta, tg) = jax.jit(jR._gates)(jp, jx), tR._gates(tp, tx)
    assert ta.dtype == tg.dtype == torch.float32
    assert float(ta.min()) > 0.0 and float(ta.max()) < 1.0
    close(ta, ja)
    close(tg, jg)


@pytest.mark.parametrize("s", [1, 7, 16, 33])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 0.999, (2, s, 24)).astype(np.float32)
    b = rng.standard_normal((2, s, 24)).astype(np.float32)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = tR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, s, 24)
    close(got, want)
    # And the sequential recurrence it computes.
    h, seq = np.zeros((2, 24), np.float32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    close(got, np.stack(seq, axis=1))


@pytest.mark.parametrize("s", [1, 12, 33])
def test_rglru_apply_output_and_state_match_jax(s):
    jcfg, tcfg, jp, tp = block(seed=s)
    jx, tx = both(np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)))
    jout, jst = jit_apply(jcfg)(jp, jx)
    tout, tst = tR.rglru_apply(tp, tx, tcfg, return_state=True)
    close(tout, jout)
    close(tst["h"], jst["h"])
    close(tst["conv"], jst["conv"])
    assert tst["h"].dtype == torch.float32
    close(tR.rglru_apply(tp, tx, tcfg), jout)


def test_rglru_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = block(seed=3)
    xs = np.random.default_rng(4).standard_normal((2, 5, jcfg.d_model))
    jc = jR.init_rglru_cache(jcfg, 2, jcfg.param_dtype)
    tc = tR.init_rglru_cache(tcfg, 2, tcfg.param_dtype, CPU)
    for name in ("h", "conv"):
        assert tc[name].shape == jc[name].shape
        assert str(tc[name].dtype) == f"torch.{jc[name].dtype}"
    jstep = jit_decode(jcfg)
    for i in range(xs.shape[1]):
        jx, tx = both(xs[:, i:i + 1])
        jy, jc = jstep(jp, jx, jc)
        ty, tc = tR.rglru_decode(tp, tx, tc, tcfg)
        close(ty, jy)
    close(tc["h"], jc["h"])
    close(tc["conv"], jc["conv"])


def test_bfloat16_rglru_matches_jax():
    """bf16 params and activations (lam, b_a, b_i and the state stay
    float32), prefill then two decode steps, at 2e-2."""
    jcfg, tcfg, jp, tp = block("bfloat16", seed=5)
    for name in ("lam", "b_a", "b_i"):
        assert tp[name].dtype == torch.float32
    assert tp["w_a"].dtype == torch.bfloat16
    xs = np.random.default_rng(6).standard_normal((2, 18, jcfg.d_model))
    jx, tx = both(xs[:, :16], "bfloat16")
    jout, jst = jit_apply(jcfg)(jp, jx)
    tout, tst = tR.rglru_apply(tp, tx, tcfg, return_state=True)
    assert tout.dtype == torch.bfloat16
    close(tout, jout, TOL["bfloat16"])
    close(tst["h"], jst["h"], TOL["bfloat16"])
    jc = {"h": jst["h"], "conv": jst["conv"]}
    tc = {"h": tst["h"], "conv": tst["conv"]}
    jstep = jit_decode(jcfg)
    for i in (16, 17):
        jx, tx = both(xs[:, i:i + 1], "bfloat16")
        jy, jc = jstep(jp, jx, jc)
        ty, tc = tR.rglru_decode(tp, tx, tc, tcfg)
        close(ty, jy, TOL["bfloat16"])
