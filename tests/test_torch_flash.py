"""The port's flash attention (``repro_torch.models.flash``) against the
JAX package's ``flash_attention`` and against dense attention, on
``tests/test_flash.py``'s (causal, window, chunk) grid and bf16 inputs:
the forward, the recompute backward's grads (against ``jax.vjp`` of JAX's
custom VJP and float64 dense autograd), the bytes kept for backward, and
the forward's bits, unchanged by the backward."""
import jax
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


# ------------------------------------------------------------- backward
def dense_torch(q, k, v, causal, window, scale):
    """Dense attention in float64 through torch autograd (the grads'
    reference)."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q, k) * scale
    q_pos, k_pos = torch.arange(q.shape[1]), torch.arange(k.shape[1])
    ok = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(ok[None, :, None, None, :], s, -1e30)
    return torch.einsum("bqkgc,bckd->bqkgd", torch.softmax(s, dim=-1), v)


def forward_only(q, k, v, causal, window, chunk, scale):
    """The port's forward as it was before the backward was added (the
    chunk loop alone), to hold the forward to the same bits."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    q32 = q.float()
    q_pos = torch.arange(sq)
    m = torch.full((b, sq, kvh, g), -torch.inf)
    l = torch.zeros((b, sq, kvh, g))
    o = torch.zeros((b, sq, kvh, g, dh))
    for c0 in range(0, sk, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        k_pos = c0 + torch.arange(chunk)
        s = torch.einsum("bqkgd,bckd->bqkgc", q32, k_i) * scale
        ok = torch.ones((sq, chunk), dtype=torch.bool)
        if causal:
            ok &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            ok &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(ok[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, v_i)
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def grads(fn, q, k, v, w):
    """(out, dq, dk, dv) of sum(fn(q, k, v) * w) by torch autograd."""
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    out.backward(w)
    return (out.detach(), *(x.grad for x in xs))


@pytest.mark.parametrize("causal,window,chunk", GRID)
def test_flash_grads_match_jax_vjp_and_dense(causal, window, chunk):
    """The recompute backward against ``jax.vjp`` of JAX's custom VJP and
    against float64 dense attention's autograd, at ``tests/test_flash.py``'s
    grad tolerance (2e-4)."""
    q, k, v = make(1)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    scale = DH ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal, window, chunk,
                                            scale),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(w))
    got = grads(lambda a, b, c: tflash(a, b, c, causal, window, chunk,
                                       scale),
                *(torch.from_numpy(x) for x in (q, k, v)),
                torch.from_numpy(w))
    dense = grads(lambda a, b, c: dense_torch(a, b, c, causal, window,
                                              scale),
                  *(torch.from_numpy(x).double() for x in (q, k, v)),
                  torch.from_numpy(w).double())
    for g, jg, dg in zip(got[1:], want, dense[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(g.numpy(), dg.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("causal,window,chunk", GRID)
def test_flash_bf16_grads_match_jax(causal, window, chunk):
    """bf16 q/k/v: the grads come back in bf16, within 2e-2 of JAX's."""
    q, k, v = make(2)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    scale = DH ** -0.5
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal, window, chunk,
                                            scale), *jx)
    want = vjp(jnp.asarray(w).astype(jnp.bfloat16))
    got = grads(lambda a, b, c: tflash(a, b, c, causal, window, chunk,
                                       scale),
                *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                torch.from_numpy(w).to(torch.bfloat16))
    for g, jg in zip(got[1:], want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(jg, np.float32), rtol=2e-2,
                                   atol=2e-2)


def saved_bytes(s):
    """Bytes autograd keeps for backward of flash over (q, k, v) of length
    ``s``, and the bytes of (q, k, v, out, lse)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in make(3, sq=s, sk=s))
    kept = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: kept.append(x.numel() * x.element_size()) or x,
            lambda x: x):
        out = tflash(q, k, v, True, None, 64, DH ** -0.5)
    lse_bytes = out.numel() // DH * 4
    five = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    return sum(kept), five + lse_bytes


def test_flash_saves_only_q_k_v_out_lse():
    """The counterpart of ``tests/test_flash.py``'s quadratic-residual
    test: backward keeps (q, k, v, out, lse) and nothing else, so what it
    keeps grows linearly in S (no per-chunk (Sq × Ck) probabilities)."""
    small, small_want = saved_bytes(256)
    big, big_want = saved_bytes(512)
    assert small == small_want and big == big_want
    assert big == 2 * small
    assert big < B * 512 * 512 * KVH * G    # far below one S² tensor


@pytest.mark.parametrize("causal,window,chunk", GRID)
def test_flash_forward_bits_unchanged(causal, window, chunk):
    """Under ``inference_mode`` (serving), without grad, and with grad
    (training), the forward gives the bits of the forward-only loop, in
    float32 and bf16."""
    scale = DH ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(x).to(dtype) for x in make(0))
        want = forward_only(q, k, v, causal, window, chunk, scale)
        with torch.inference_mode():
            assert torch.equal(tflash(q, k, v, causal, window, chunk, scale),
                               want)
        with torch.no_grad():
            assert torch.equal(tflash(q, k, v, causal, window, chunk, scale),
                               want)
        out = tflash(q.requires_grad_(), k, v, causal, window, chunk, scale)
        assert out.requires_grad and torch.equal(out.detach(), want)
