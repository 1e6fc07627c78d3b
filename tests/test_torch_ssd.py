"""The port's Mamba2 / SSD block (``repro_torch.models.ssd``) against the JAX
package's (``repro.models.ssd``): the same params (JAX's, carried across as
numpy) and the same numpy inputs give the same causal conv, segment sums,
chunked scan (one chunk, several, and a gcd chunking), full-sequence
mixer with its decode state, and token-by-token decode; float32 at rtol =
atol = 1e-5, bfloat16 at 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import ssd as jS
from repro_torch.models import ssd as tS
from repro_torch.common.pytree import tree_map
from repro_torch.models.zoo import _tensor

ARCH = "mamba2-370m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = torch.device("cpu")


def cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=dtype))


def block(dtype="float32", seed=0):
    """(JAX cfg, port cfg, JAX params, the same params as tensors)."""
    jcfg, tcfg = cfgs(dtype)
    jp = jax.jit(lambda k: jS.init_mamba(k, jcfg, jcfg.param_dtype))(
        jax.random.PRNGKey(seed))
    tp = tree_map(lambda a: _tensor(np.asarray(a), CPU), jp)
    return jcfg, tcfg, jp, tp


def jit_apply(jcfg):
    """JAX's full-sequence mixer with its decode state, jitted."""
    return jax.jit(lambda p, x: jS.mamba_apply(p, x, jcfg, None,
                                               return_state=True))


def jit_decode(jcfg):
    """JAX's one-token update, jitted."""
    return jax.jit(lambda p, x, c: jS.mamba_decode(p, x, c, jcfg, None))


def both(a, dtype=np.float32):
    """A numpy array as a JAX array and a tensor of the same values."""
    a = np.asarray(a, np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                                np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    jx, tx = both(rng.standard_normal((2, 9, 12)))
    jw, tw = both(rng.standard_normal((4, 12)) * 0.3)
    jb, tb = both(rng.standard_normal(12) * 0.1)
    if with_state:
        js, ts = both(rng.standard_normal((2, 3, 12)))
        (jy, jst), (ty, tst) = (jS._causal_conv(jx, jw, jb, state=js),
                                tS._causal_conv(tx, tw, tb, state=ts))
    else:
        close(tS._causal_conv(tx, tw, tb), jS._causal_conv(jx, jw, jb))
        (jy, jst), (ty, tst) = (
            jS._causal_conv(jx, jw, jb, return_state=True),
            tS._causal_conv(tx, tw, tb, return_state=True))
    close(ty, jy)
    assert tst.shape == (2, 3, 12)
    close(tst, jst)


def test_segsum_matches_jax():
    ja, ta = both(np.random.default_rng(2).standard_normal((2, 3, 8)))
    want, got = np.asarray(jS._segsum(ja)), tS._segsum(ta).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all() and not np.isinf(
        np.diagonal(got, axis1=-2, axis2=-1)).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(16, 16), (32, 8), (24, 8)],
                         ids=["one-chunk", "four-chunks", "gcd-chunks"])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s + chunk)
    h, p, n = 4, 16, 16
    jx, tx = both(rng.standard_normal((2, s, h, p)))
    jdt, tdt = both(np.log1p(np.exp(rng.standard_normal((2, s, h)))))
    ja, ta = both(-np.exp(np.log(np.linspace(1.0, 16.0, h))))
    jb, tb = both(rng.standard_normal((2, s, n)))
    jc, tc = both(rng.standard_normal((2, s, n)))
    jy, jh = jax.jit(jS.ssd_chunked, static_argnums=5)(jx, jdt, ja, jb, jc,
                                                      chunk)
    ty, th = tS.ssd_chunked(tx, tdt, ta, tb, tc, chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (2, s, h, p) and th.shape == (2, h, p, n)
    close(ty, jy)
    close(th, jh)


@pytest.mark.parametrize("s", [16, 24, 40], ids=["s16", "s24-gcd8",
                                                   "s40-gcd8"])
def test_mamba_apply_output_and_state_match_jax(s):
    jcfg, tcfg, jp, tp = block(seed=s)
    jx, tx = both(np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)))
    jout, jst = jit_apply(jcfg)(jp, jx)
    tout, tst = tS.mamba_apply(tp, tx, tcfg, return_state=True)
    close(tout, jout)
    close(tst["h"], jst["h"])
    close(tst["conv"], jst["conv"])
    assert tst["h"].dtype == torch.float32
    close(tS.mamba_apply(tp, tx, tcfg), jout)


def test_mamba_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = block(seed=3)
    xs = np.random.default_rng(4).standard_normal((2, 5, jcfg.d_model))
    jc = jS.init_mamba_cache(jcfg, 2, jcfg.param_dtype)
    tc = tS.init_mamba_cache(tcfg, 2, tcfg.param_dtype, CPU)
    for name in ("h", "conv"):
        assert tc[name].shape == jc[name].shape
        assert str(tc[name].dtype) == f"torch.{jc[name].dtype}"
    jstep = jit_decode(jcfg)
    for i in range(xs.shape[1]):
        jx, tx = both(xs[:, i:i + 1])
        jy, jc = jstep(jp, jx, jc)
        ty, tc = tS.mamba_decode(tp, tx, tc, tcfg)
        close(ty, jy)
    close(tc["h"], jc["h"])
    close(tc["conv"], jc["conv"])


def test_bfloat16_mamba_matches_jax():
    """bf16 params and activations (A_log, D, dt_bias and the state stay
    float32), prefill then two decode steps, at 2e-2."""
    jcfg, tcfg, jp, tp = block("bfloat16", seed=5)
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    xs = np.random.default_rng(6).standard_normal((2, 18, jcfg.d_model))
    jx, tx = both(xs[:, :16], "bfloat16")
    jout, jst = jit_apply(jcfg)(jp, jx)
    tout, tst = tS.mamba_apply(tp, tx, tcfg, return_state=True)
    assert tout.dtype == torch.bfloat16
    close(tout, jout, TOL["bfloat16"])
    close(tst["h"], jst["h"], TOL["bfloat16"])
    jc = {"h": jst["h"], "conv": jst["conv"]}
    tc = {"h": tst["h"], "conv": tst["conv"]}
    jstep = jit_decode(jcfg)
    for i in (16, 17):
        jx, tx = both(xs[:, i:i + 1], "bfloat16")
        jy, jc = jstep(jp, jx, jc)
        ty, tc = tS.mamba_decode(tp, tx, tc, tcfg)
        close(ty, jy, TOL["bfloat16"])
