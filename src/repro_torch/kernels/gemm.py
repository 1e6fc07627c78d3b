"""TPU-like dense GEMM (U_M U_K, U_K U_N) on Hopper — the port of
``repro.kernels.gemm``: ``a (M, K) @ b (K, N)``, accumulated in f32 and
rounded once to ``result_type(a, b)``.

The TPU kernel keeps a ``(bm, bn)`` f32 accumulator in VMEM across its K
grid; the CUDA kernel (``csrc/gemm.cu``) keeps it in registers across the K
loop of one block, on the tiled f32 product the sparse bodies share
(``csrc/tiled_gemm.cuh``). It runs true f32 FMAs, never TF32.

:func:`gemm_plain` is its plain PyTorch version, which :func:`gemm` runs
for tensors on the CPU and only then. A CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: Kernel launches since the count was last reset.
launches = {"gemm": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gemm_launch": [_P, _P, _P, _I, _I, _I, _I, _P]}


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one rank-1 update of an f32 accumulator per
    K index, the loop order of the TPU kernel's K grid."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    af, bf = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc.addcmul_(af[:, k:k + 1], bf[k:k + 1, :])
    return acc.to(out_dtype)


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` in ``result_type(a, b)``: the CUDA kernel on
    the card, :func:`gemm_plain` for CPU tensors. Any shape is taken (the
    kernel masks ragged tiles); ``ops.gemm`` pads to the JAX package's
    blocks first, so both packages see the same launch shapes."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    _build.require_cuda_operands("gemm", a, b)
    code = _build.dtype_code("gemm", a.dtype, b.dtype)
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    lib = _build.load("gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        _build.check(lib.gemm_launch(
            _build.ptr(a), _build.ptr(b), _build.ptr(out), m, k, n, code,
            _build.stream(a.device)), "gemm")
    launches["gemm"] += 1
    return out
