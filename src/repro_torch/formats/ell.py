"""Static-capacity compressed fibers (ELL-style) on tensors — the port of
``repro.formats.ell``.

A compressed inner mode stores up to ``cap`` nonzeros per fiber, padded
with ``id = -1`` sentinels. ``major_axis`` selects which logical axis the
fibers run along:

* A in ``U_M C_K``  -> ``major_axis=0`` (row fibers, ids index K)
* A in ``U_K C_M``  -> ``major_axis=1`` (column fibers, ids index M)
* B in ``U_N C_K``  -> ``major_axis=1`` (column fibers, ids index K)
* B in ``U_K C_N``  -> ``major_axis=0`` (row fibers, ids index N)

Every function here is plain torch on whatever device its input lies on;
:func:`ell_from_numpy`/:func:`ell_to_numpy` carry an ELL between this
package and the JAX one as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

PAD_ID = -1


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """A 2-D matrix with one compressed mode at static capacity.

    ``vals``/``ids`` have shape ``(n_fibers, cap)``; ``lens`` has shape
    ``(n_fibers,)``. ``ids[i, j]`` is the minor-axis coordinate of the j-th
    nonzero of fiber ``i`` (ascending), ``PAD_ID`` beyond ``lens[i]``.
    ``ids`` and ``lens`` are int32. ``shape`` is the logical dense shape;
    ``major_axis`` the fiber axis.
    """

    vals: torch.Tensor
    ids: torch.Tensor
    lens: torch.Tensor
    shape: Tuple[int, int]
    major_axis: int

    @property
    def cap(self) -> int:
        return self.vals.shape[1]

    @property
    def n_fibers(self) -> int:
        return self.vals.shape[0]

    @property
    def minor_size(self) -> int:
        return self.shape[1 - self.major_axis]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def nnz(self) -> torch.Tensor:
        return self.lens.sum()

    def density(self) -> torch.Tensor:
        return self.nnz() / (self.shape[0] * self.shape[1])

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(self, vals=self.vals.to(device),
                                   ids=self.ids.to(device),
                                   lens=self.lens.to(device))


def dense_to_ell(dense: torch.Tensor, major_axis: int, cap: int,
                 strict: bool = False) -> EllMatrix:
    """Compress ``dense`` along the minor axis with static capacity ``cap``.

    By default nonzeros beyond ``cap`` in a fiber are silently dropped (a
    deliberate truncation policy). Pass ``strict=True`` whenever ``cap``
    was derived from the true fiber occupancy: overflow then raises
    :class:`ValueError` naming the worst fiber. ``strict`` forces one host
    synchronisation; the executor enforces the same contract with its one
    batched capacity fetch instead (``core/hetero_matmul.py``).
    """
    assert dense.ndim == 2, dense.shape
    work = dense if major_axis == 0 else dense.T
    mask = work != 0
    lens = mask.sum(dim=-1, dtype=torch.int32)
    if strict:
        worst = int(lens.max()) if lens.numel() else 0
        if worst > cap:
            raise ValueError(
                f"dense_to_ell(strict=True): a fiber holds {worst} "
                f"nonzeros but cap={cap} (major_axis={major_axis}, "
                f"shape={tuple(dense.shape)}); raise the capacity (see "
                "bucket_capacity) or drop strict if truncation is intended")
    # A stable argsort of ~mask floats the nonzero coordinates (in
    # ascending order) to the front of each fiber.
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    width = min(cap, work.shape[-1])
    take = order[:, :width]
    within = (torch.arange(width, device=dense.device)[None, :]
              < torch.clamp(lens, max=width)[:, None])
    ids = torch.where(within, take.to(torch.int32),
                      torch.full_like(take, PAD_ID, dtype=torch.int32))
    vals = torch.take_along_dim(work, take, dim=-1)
    vals = torch.where(within, vals, torch.zeros_like(vals))
    if width < cap:  # capacity exceeds minor size: pad out to static cap
        pad = cap - width
        ids = torch.nn.functional.pad(ids, (0, pad), value=PAD_ID)
        vals = torch.nn.functional.pad(vals, (0, pad))
    return EllMatrix(
        vals=vals.contiguous(),
        ids=ids.contiguous(),
        lens=torch.clamp(lens, max=width),
        shape=tuple(dense.shape),
        major_axis=major_axis,
    )


def ell_to_dense(e: EllMatrix) -> torch.Tensor:
    """Scatter an :class:`EllMatrix` back to dense. A slot whose id lies
    outside ``[0, minor_size)`` is dropped, as JAX's out-of-range scatter
    drops it."""
    minor = e.minor_size
    # PAD_ID slots, and ids out of range, scatter into a discard column.
    safe = torch.where((e.ids >= 0) & (e.ids < minor), e.ids, minor).long()
    out = torch.zeros((e.n_fibers, minor + 1), dtype=e.vals.dtype,
                      device=e.vals.device)
    out.scatter_add_(1, safe, e.vals)
    out = out[:, :minor]
    return out.T if e.major_axis == 1 else out


def check_capacity(dense, major_axis: int, cap: int) -> bool:
    """True iff every fiber of ``dense`` fits within ``cap`` nonzeros."""
    work = torch.as_tensor(dense)
    return bool(((work != 0).sum(dim=1 - major_axis) <= cap).all())


def required_capacity(dense, major_axis: int, align: int = 8) -> int:
    """Smallest aligned capacity holding every fiber of ``dense`` (one host
    read of the fullest fiber's count)."""
    work = torch.as_tensor(dense)
    need = (int((work != 0).sum(dim=1 - major_axis).max())
            if work.numel() else 0)
    need = max(need, 1)
    return int(-(-need // align) * align)


def bucket_capacity(cap: int, align: int = 8, max_cap: int | None = None) -> int:
    """Round a tight capacity up to a power-of-two bucket, so nearby caps
    share launch shapes. ``max_cap`` (usually the fiber's minor size)
    clips the bucket so it never allocates beyond what the fiber could
    hold — but never below ``cap`` itself, so bucketing drops no nonzero.
    """
    need = max(int(cap), 1)
    bucket = max(int(align), 1)
    while bucket < need:
        bucket *= 2
    if max_cap is not None:
        ceil_aligned = -(-int(max_cap) // align) * align
        bucket = max(min(bucket, ceil_aligned), need)
    return bucket


def pad_capacity(e: EllMatrix, cap: int) -> EllMatrix:
    """Grow ``e``'s static capacity to ``cap`` (PAD_ID/zero padding only —
    the logical matrix is unchanged)."""
    assert cap >= e.cap, (cap, e.cap)
    if cap == e.cap:
        return e
    pad = cap - e.cap
    return dataclasses.replace(
        e,
        vals=torch.nn.functional.pad(e.vals, (0, pad)),
        ids=torch.nn.functional.pad(e.ids, (0, pad), value=PAD_ID),
    )


def block_chunk_counts(e: EllMatrix, block: int, chunk: int = 1) -> torch.Tensor:
    """Per-fiber-block live capacity-chunk counts: ``ceil(max lens / chunk)``
    over each block of ``block`` fibers. Every chunk beyond that count is
    all padding, so a kernel may skip it without dropping a nonzero.

    Returns int32 ``(n_fibers // block,)``; ``n_fibers`` must be a multiple
    of ``block`` (the ops layer pads fibers to guarantee it).
    """
    nf = e.n_fibers
    assert nf % block == 0, (nf, block)
    assert chunk >= 1, chunk
    per_block = e.lens.reshape(nf // block, block).amax(dim=1)
    return torch.div(per_block + (chunk - 1), chunk,
                     rounding_mode="floor").to(torch.int32)


def block_window_nnz(e: EllMatrix, window: int) -> torch.Tensor:
    """Per-minor-window nonzero counts over all fibers: window ``w`` covers
    minor coordinates ``[w·window, (w+1)·window)``. A zero count proves no
    fiber lands in that window, so a kernel may skip every tile reading it.
    PAD slots and ids past the last window's discard bucket count nowhere,
    as in the JAX package. A ``scatter_add_`` into a fixed-size buffer, so
    no host sync. Returns int32 ``(ceil(minor_size / window),)``.
    """
    n_win = -(-e.minor_size // window)
    live = e.ids >= 0
    win = torch.where(live, torch.div(e.ids, window, rounding_mode="floor"),
                      n_win).clamp_(max=n_win)    # pad -> discard bucket
    counts = torch.zeros(n_win + 1, dtype=torch.int32, device=e.ids.device)
    counts.scatter_add_(0, win.reshape(-1).long(),
                        live.reshape(-1).to(torch.int32))
    return counts[:n_win]


def tile_occupancy(e: EllMatrix, tile: int) -> torch.Tensor:
    """Per-(fiber, minor-tile) nonzero counts: entry ``[f, t]`` counts the
    nonzeros of fiber ``f`` with minor coordinate in ``[t·tile,
    (t+1)·tile)``. Each fiber's counts go to its own row of an
    ``(n_fibers, n_tiles + 1)`` buffer by ``scatter_add_`` (no host sync);
    PAD slots and ids at or past ``n_tiles·tile`` land in the row's discard
    bucket, so nothing spills into another fiber, and an id in
    ``[minor_size, n_tiles·tile)`` counts in the last tile, as in the JAX
    package. The work is the ELL's size, not ``n_fibers × cap × n_tiles``.
    Returns int32 ``(n_fibers, ceil(minor_size / tile))``.
    """
    n_tiles = -(-e.minor_size // tile)
    t = torch.where(e.ids >= 0, torch.div(e.ids, tile, rounding_mode="floor"),
                    n_tiles).clamp_(max=n_tiles).long()
    counts = torch.zeros((e.n_fibers, n_tiles + 1), dtype=torch.int32,
                         device=e.ids.device)
    counts.scatter_add_(1, t, torch.ones_like(t, dtype=torch.int32))
    return counts[:, :n_tiles]


def ell_from_numpy(vals, ids, lens, shape, major_axis: int,
                   device) -> EllMatrix:
    """An :class:`EllMatrix` on ``device`` from numpy arrays (for instance
    the fields of a JAX ``EllMatrix`` after ``np.asarray``). numpy's
    bfloat16 extension type becomes ``torch.bfloat16`` exactly."""
    vals = np.asarray(vals)
    if vals.dtype.name == "bfloat16":
        tvals = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    else:
        tvals = torch.from_numpy(vals.copy())
    return EllMatrix(
        vals=tvals.to(device),
        ids=torch.from_numpy(np.asarray(ids, np.int32).copy()).to(device),
        lens=torch.from_numpy(np.asarray(lens, np.int32).copy()).to(device),
        shape=(int(shape[0]), int(shape[1])),
        major_axis=int(major_axis),
    )


def ell_to_numpy(e: EllMatrix):
    """``(vals, ids, lens, shape, major_axis)`` with numpy arrays — the
    inverse of :func:`ell_from_numpy`. bf16 values come back as float32
    (numpy has no bfloat16); the conversion is exact."""
    vals = e.vals.detach().cpu()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    return (vals.numpy(), e.ids.detach().cpu().numpy(),
            e.lens.detach().cpu().numpy(), tuple(e.shape), e.major_axis)
