"""TPU-like dense GEMM (U_M U_K, U_K U_N) on Hopper — the port of
``repro.kernels.gemm`` (``_gemm_kernel``): ``a (M, K) @ b (K, N)``,
accumulated in f32 and rounded once to ``result_type(a, b)``.

The TPU kernel keeps a ``(bm, bn)`` f32 accumulator in VMEM across its K
grid. The CUDA kernel (``csrc/gemm.cu``) keeps it in registers across the K
loop of one block: 128 x 128 output tiles, K in steps of 32 through a
four-stage ``cp.async`` ring in shared memory, 8 x 8 accumulators a
thread fed from bank-conflict-free fragments, one block an SM. It runs
true f32 FMAs, never TF32, so the card's f32 rate bounds it (2·M·K·N
operations at 67 TFLOP/s on the H100 SXM).

The wave tail is part of the launch plan (:func:`gemm_plan`): where the
last wave of tiles would run less than half full, each of its tiles is
split along K into pieces that run as one short wave, and the last piece
of a tile to finish adds the pieces' partial tiles in piece order (the
same bits on every run).

:func:`gemm_plain` is its plain PyTorch version, which :func:`gemm` runs
for tensors on the CPU and only then. A CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

#: The kernel's output tile (``GM_M`` x ``GM_N`` in ``csrc/gemm.cu``) and
#: its K step (``GM_K``).
GEMM_TILE_M = 128
GEMM_TILE_N = 128
GEMM_K_STEP = 32

#: The fewest K steps a piece of a split tail tile gets: below it the
#: partial tile's write and read cost more than the wave they save.
GEMM_MIN_PIECE_STEPS = 8

#: Kernel launches since the count was last reset.
launches = {"gemm": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gemm_launch": [_P, _P, _P] + [_I] * 7 + [_P, _P, _I, _I, _P],
    "gemm_blocks_per_sm": [_I, _P],
}

#: Block slots (SMs x blocks per SM) per (device index, dtype code).
_slots = {}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How a launch covers its tiles: the first ``dp_tiles`` tiles whole,
    one block each, then each of the ``tiles - dp_tiles`` tail tiles in
    ``splits`` K pieces, one block each."""

    tiles: int
    dp_tiles: int
    splits: int

    @property
    def tail(self) -> int:
        return self.tiles - self.dp_tiles

    @property
    def blocks(self) -> int:
        return self.dp_tiles + self.tail * self.splits


def gemm_plan(m: int, k: int, n: int, slots: int) -> GemmPlan:
    """The launch plan for an ``(m, k) x (k, n)`` product on ``slots``
    block slots. With ``tail = tiles % slots`` tiles in the last wave, a
    tail that fills at most half of it is split: each tail tile into
    ``min(slots // tail, k_steps // GEMM_MIN_PIECE_STEPS)`` pieces, when
    that is at least 2; otherwise every tile is computed whole."""
    assert slots >= 1, slots
    tiles = -(-m // GEMM_TILE_M) * -(-n // GEMM_TILE_N)
    steps = -(-k // GEMM_K_STEP)
    tail = tiles % slots
    splits = 1
    if tail and 2 * tail <= slots:
        splits = min(slots // tail, steps // GEMM_MIN_PIECE_STEPS)
    if splits < 2:
        return GemmPlan(tiles, tiles, 1)
    return GemmPlan(tiles, tiles - tail, splits)


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


def block_slots(device: torch.device, code: int) -> int:
    """Blocks of the kernel the card runs at once: its SMs times the
    blocks one SM holds (the kernel's occupancy, asked of the runtime once
    per device and dtype)."""
    key = (device.index, code)
    if key not in _slots:
        lib = _build.load("gemm", _SIGNATURES)
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.gemm_blocks_per_sm(code, ctypes.byref(per_sm)),
                         "gemm occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _slots[key] = max(1, per_sm.value) * sms
    return _slots[key]


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
    dev = a.device
    out = torch.empty((m, n), dtype=dtype, device=dev)
    plan = gemm_plan(m, k, n, block_slots(dev, code))
    ws = arrived = None
    if plan.splits > 1:
        ws = torch.empty(plan.tail * plan.splits * GEMM_TILE_M * GEMM_TILE_N,
                         dtype=torch.float32, device=dev)
        arrived = torch.zeros(plan.tail, dtype=torch.int32, device=dev)
    size = a.element_size()
    aligned = (_build.row_granule(a) * size >= 16
               and _build.row_granule(b) * size >= 16)
    lib = _build.load("gemm", _SIGNATURES)
    P = _build.ptr
    with torch.cuda.device(dev):
        _build.check(lib.gemm_launch(
            P(a), P(b), P(out), m, k, n, -(-n // GEMM_TILE_N), plan.dp_tiles,
            plan.splits, plan.blocks,
            None if ws is None else P(ws),
            None if arrived is None else P(arrived), int(aligned), code,
            _build.stream(dev)), "gemm")
    launches["gemm"] += 1
    return out
