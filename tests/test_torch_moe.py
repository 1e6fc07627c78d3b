"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's: ``moe_mlp`` with its capacity drops, the routing, the
load-balancing loss, and ``routing_as_ell`` — the routing matrix as the
paper's U_T C_E tensor — through the port's SpMM."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import moe as jM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmm as tspmm
from repro_torch.models import moe as tM

TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_moe.py


def configs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw),
            dataclasses.replace(tconfigs.get_reduced(arch), **kw))


def params(jcfg, seed=0):
    """JAX's ``init_moe`` params, and the same numbers as tensors."""
    jp = jM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
@pytest.mark.parametrize("cf", [1e-9, 1.25, 16.0])
def test_moe_mlp_matches_jax(arch, cf):
    """The same output within 2e-4, the same routing weights and experts,
    at a capacity that drops most tokens, the default one (some drop) and
    one that drops none."""
    jcfg, tcfg = configs(arch, capacity_factor=cf)
    jp, tp = params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    want, (jw, jidx) = jM.moe_mlp(jp, jnp.asarray(x), jcfg, None)
    got, (tw, tidx) = tM.moe_mlp(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_mlp_gelu_matches_jax():
    """``act="gelu"`` takes JAX's tanh GELU, not torch's default erf."""
    jcfg, tcfg = configs("olmoe-1b-7b", act="gelu", capacity_factor=16.0)
    jp, tp = params(jcfg, seed=2)
    x = 3.0 * np.random.default_rng(3).standard_normal(
        (1, 16, jcfg.d_model)).astype(np.float32)
    want, _ = jM.moe_mlp(jp, jnp.asarray(x), jcfg, None)
    got, _ = tM.moe_mlp(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_dense_equivalence_topk_equals_experts():
    """With k == E and room for every token, MoE equals the dense mixture
    Σ_e softmax_e(router) · FFN_e(x) (``tests/test_moe.py``)."""
    _, tcfg = configs("olmoe-1b-7b", n_experts=4, experts_per_token=4,
                      capacity_factor=8.0)
    tp = tM.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.randn((2, 8, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    got, _ = tM.moe_mlp(tp, x, tcfg)
    xf = x.reshape(-1, tcfg.d_model).double()
    probs = torch.softmax(xf @ tp["router"].double(), dim=-1)
    want = torch.zeros_like(xf)
    for e in range(tcfg.n_experts):
        h = (torch.nn.functional.silu(xf @ tp["wg"][e].double())
             * (xf @ tp["wi"][e].double()))
        want += probs[:, e:e + 1] * (h @ tp["wo"][e].double())
    np.testing.assert_allclose(got.reshape(-1, tcfg.d_model).numpy(),
                               want.numpy(), **TOL)


@pytest.mark.parametrize("collapsed", [False, True])
def test_aux_load_balance_loss_matches_jax(collapsed):
    t, e = 512, 8
    rng = np.random.default_rng(0)
    idx = (np.zeros((t, 2), np.int32) if collapsed
           else rng.integers(0, e, (t, 2)).astype(np.int32))
    w = rng.random((t, 2)).astype(np.float32)
    want = float(jM.aux_load_balance_loss(jnp.asarray(w), jnp.asarray(idx),
                                          e))
    got = tM.aux_load_balance_loss(torch.from_numpy(w),
                                   torch.from_numpy(idx), e)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def routing(t=32, e=8, k=2, seed=1):
    """Top-k routing of random logits, through JAX (weights, experts)."""
    logits = np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)
    wts, idx = jax.lax.top_k(jnp.asarray(logits), k)
    return np.array(jax.nn.softmax(wts, axis=-1)), np.array(idx)


def test_routing_as_ell_matches_jax():
    wts, idx = routing()
    je = jM.routing_as_ell(jnp.asarray(wts), jnp.asarray(idx), 8)
    te = tM.routing_as_ell(torch.from_numpy(wts), torch.from_numpy(idx), 8)
    assert te.shape == je.shape == (32, 8)
    assert te.major_axis == je.major_axis == 0 and te.cap == 2
    assert te.ids.dtype == te.lens.dtype == torch.int32
    np.testing.assert_array_equal(te.ids.numpy(), np.asarray(je.ids))
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    np.testing.assert_array_equal(te.lens.numpy(), np.asarray(je.lens))


@pytest.mark.parametrize("method", ["auto", "reference"])
def test_routing_through_the_port_spmm(method):
    """``R @ S`` through the port's mirrored SpMM (its plain version on the
    CPU) equals the dense product (``tests/test_moe.py``'s
    ``test_routing_as_ell_is_paper_spmm``); at K = E = 64 and cap 8,
    "auto" takes the sparse body."""
    t, e, k = 64, 64, 8
    wts, idx = routing(t, e, k, seed=4)
    ell = tM.routing_as_ell(torch.from_numpy(wts), torch.from_numpy(idx), e)
    s = np.random.default_rng(5).standard_normal((e, 16)).astype(np.float32)
    assert tspmm.resolve_method("auto", e, ell.cap) == "sparse"
    got = tops.spmm_mirror(ell, torch.from_numpy(s), method=method,
                           device="cpu")
    r = np.zeros((t, e), np.float64)
    np.add.at(r, (np.arange(t)[:, None], idx), wts)
    np.testing.assert_allclose(got.numpy(), r @ s, rtol=1e-4, atol=1e-4)
