"""Absorbed latent attention for decode on Hopper: :func:`mla_attend` runs
the scores, softmax and weighted sum of latents of
:func:`repro_torch.models.mla.absorbed_attend` with the kernels of
``csrc/mla_decode.cu``, which read each row's valid positions ``[0, pos]``
of the bfloat16 latent cache once, where it lies, and keep the rest on
chip. ``absorbed_attend`` calls it for every CUDA tensor; on the CPU it
runs its plain code, the reference.

It replaces no TPU kernel (the JAX package has no MLA); it is bound by its
bytes, 1152 a key and layer. The launch depends on no host value of
``pos``: a fixed grid of :data:`CHUNK`-position chunks of the cache, rows
and head groups of 16, whose blocks read ``pos`` on the device, then a
merge of each row's chunks. So a captured CUDA graph replays it for any
``pos``. Scratch comes from ``torch.empty``, the graph's pool under
capture.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: Calls of :func:`mla_attend` that launched the kernels (one split and one
#: merge) since the count was last reset.
launches = {"mla_attend": 0}

#: The widths the kernels are built for (``rt::MLA_RANK``, ``MLA_ROPE``),
#: heads a block (``MLA_HEADS``), and positions a chunk, a block of the
#: split kernel each (a multiple of ``rt::MLA_TILE``, 32; the choice is in
#: the source's note).
RANK, ROPE, HEADS = 512, 64, 16
CHUNK = 1024

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "mla_attend_launch": [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
                          _P, _I, _I, _I, _I, _F, _P, _P, _P, _P],
}


def check_operands(q_lat: torch.Tensor, q_pe: torch.Tensor,
                   c_cache: torch.Tensor, pe_cache: torch.Tensor,
                   pos: torch.Tensor) -> Tuple[int, int, int]:
    """Raise ``ValueError`` on operands the kernels do not take; returns
    (rows, heads, slots). q_lat (B, H, 512) and q_pe (B, H, 64) float32;
    the caches (B, S, 512) and (B, S, 64) bfloat16, each position's row
    contiguous, the row and position strides multiples of 8 elements and
    the first element 16-byte aligned (16-byte copies); pos (B,) int32; H
    a multiple of 16. Device-blind: :func:`mla_attend` checks the
    device."""
    what = "mla_attend"
    b, h = q_lat.shape[:2] if q_lat.dim() == 3 else (None, None)
    want = {"q_lat": (q_lat, (b, h, RANK), torch.float32),
            "q_pe": (q_pe, (b, h, ROPE), torch.float32),
            "c_cache": (c_cache, (b, None, RANK), torch.bfloat16),
            "pe_cache": (pe_cache, (b, None, ROPE), torch.bfloat16)}
    s = c_cache.shape[1] if c_cache.dim() == 3 else None
    for name, (t, shape, dtype) in want.items():
        shape = tuple(s if n is None else n for n in shape)
        if t.dim() != 3 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)}, "
                             f"the kernels take {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, the kernels "
                             f"take {dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{what}: {name}'s last axis must be "
                             f"contiguous, stride {t.stride(2)}")
    for name, t in (("c_cache", c_cache), ("pe_cache", pe_cache)):
        if (t.stride(0) % 8 or t.stride(1) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name}'s rows must start 16-byte "
                             f"aligned, strides {t.stride()}")
    if h % HEADS:
        raise ValueError(f"{what}: {h} heads, the kernels take a multiple "
                         f"of {HEADS}")
    if (pos.dim() != 1 or pos.shape[0] != b or pos.dtype != torch.int32
            or (b > 1 and pos.stride(0) != 1)):
        raise ValueError(f"{what}: pos must be a contiguous int32 ({b},), "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    if b == 0 or s == 0:
        raise ValueError(f"{what}: an empty batch or cache")
    return b, h, s


def mla_attend(q_lat: torch.Tensor, q_pe: torch.Tensor,
               c_cache: torch.Tensor, pe_cache: torch.Tensor,
               pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The absorbed attention's latent output on the card, on PyTorch's
    current stream: row b's heads attend keys ``[0, pos[b]]``, scores
    ``scale · (q_lat·c + q_pe·k_pe)`` -> o_lat (B, H, 512) float32, ``Σ p
    c``. ``pos`` must lie in ``[0, S)`` (the caller bounds it; it is not
    read on the host). Raises on operands the kernels do not take."""
    b, h, s = check_operands(q_lat, q_pe, c_cache, pe_cache, pos)
    dev = q_lat.device
    for t in (q_pe, c_cache, pe_cache, pos):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"mla_attend: operands must share one CUDA "
                             f"device, got {t.device} and {dev}")
    n_chunks = -(-s // CHUNK)
    part_o = torch.empty((b, n_chunks, h, RANK), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((b, n_chunks, h, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((b, h, RANK), dtype=torch.float32, device=dev)
    lib = _build.load("mla_decode", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.mla_attend_launch(
            P(q_lat), q_lat.stride(0), q_lat.stride(1),
            P(q_pe), q_pe.stride(0), q_pe.stride(1),
            P(c_cache), c_cache.stride(0), c_cache.stride(1),
            P(pe_cache), pe_cache.stride(0), pe_cache.stride(1),
            P(pos), b, h, s, CHUNK, scale, P(part_o), P(part_ml), P(out),
            _build.stream(dev)), "mla_attend")
    launches["mla_attend"] += 1
    return out
