"""The port's flash attention forward (``repro_torch.models.flash``)
against the JAX package's ``flash_attention`` and against dense attention,
on ``tests/test_flash.py``'s (causal, window, chunk) grid and bf16
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention as jflash
from repro_torch.models.flash import flash_attention as tflash

B, SQ, SK, KVH, G, DH = 2, 16, 24, 2, 3, 8
GRID = [(True, None, 8), (False, None, 8), (True, 6, 8), (True, None, 24),
        (True, 4, 4)]


def make(seed, sq=SQ, sk=SK):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, sq, KVH, G, DH)).astype(np.float32),
            rng.standard_normal((B, sk, KVH, DH)).astype(np.float32),
            rng.standard_normal((B, sk, KVH, DH)).astype(np.float32))


def dense_ref(q, k, v, causal, window, scale):
    """Dense attention in float64 (numpy)."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum("bqkgd,bckd->bqkgc", q, k) * scale
    q_pos, k_pos = np.arange(q.shape[1]), np.arange(k.shape[1])
    ok = np.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = np.where(ok[None, :, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bqkgc,bckd->bqkgd", p, v)


@pytest.mark.parametrize("causal,window,chunk", GRID)
def test_flash_forward_matches_jax_and_dense(causal, window, chunk):
    q, k, v = make(0)
    scale = DH ** -0.5
    got = tflash(*(torch.from_numpy(x) for x in (q, k, v)), causal, window,
                 chunk, scale)
    want = jflash(*(jnp.asarray(x) for x in (q, k, v)), causal, window,
                  chunk, scale)
    assert got.dtype == torch.float32 and got.shape == (B, SQ, KVH, G, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense_ref(q, k, v, causal,
                                                      window, scale),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,chunk", GRID)
def test_flash_bf16_inputs_match_jax(causal, window, chunk):
    """bf16 q/k/v (the same bits in both packages): the output stays bf16,
    within 2e-2 of JAX's and of dense attention."""
    q, k, v = make(2)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    for jx, tx in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                      tx.float().numpy())
    got = tflash(tq, tk, tv, causal, window, chunk, DH ** -0.5)
    want = jflash(jq, jk, jv, causal, window, chunk, DH ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    ref = dense_ref(tq.float().numpy(), tk.float().numpy(),
                    tv.float().numpy(), causal, window, DH ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_flash_rejects_uneven_chunks():
    q, k, v = (torch.from_numpy(x) for x in make(1))
    with pytest.raises(AssertionError):
        tflash(q, k, v, True, None, 7, DH ** -0.5)
