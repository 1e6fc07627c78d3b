"""Dense oracles for the ported dataflow classes — the port of
``repro.kernels.ref``: the paper's TACO loop nests (Fig 2a-2e) as
vectorised torch on whatever device the operands lie on. Tests hold the
kernels' plain versions against these; nothing on the executor's path
calls them.

Operand conventions (paper M×K×N): A : M×K, B : K×N, O : M×N.
"""
from __future__ import annotations

import torch

from repro_torch.formats.ell import EllMatrix


def _acc_dtype(*dtypes: torch.dtype) -> torch.dtype:
    out = torch.float32
    for d in dtypes:
        out = torch.promote_types(out, d)
    return out


def _scatter_dense(e: EllMatrix, acc: torch.dtype) -> torch.Tensor:
    """Compressed fibers -> dense ``(n_fibers, minor_size)`` in ``acc``.
    PAD_ID entries land in a discard column and their values are masked to
    zero."""
    live = e.ids >= 0
    safe = torch.where(live, e.ids, e.minor_size).long()
    vals = torch.where(live, e.vals.to(acc), 0)
    out = torch.zeros((e.n_fibers, e.minor_size + 1), dtype=acc,
                      device=e.vals.device)
    return out.scatter_add_(1, safe, vals)[:, : e.minor_size]


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(U_M U_K, U_K U_N) — TPU-like dense GEMM: ``for m; for n; for k``,
    accumulated in f32 or the operands' wider type."""
    acc = _acc_dtype(a.dtype, b.dtype)
    out = (a.to(acc)[:, :, None] * b.to(acc)[None]).sum(dim=1)
    return out.to(torch.promote_types(a.dtype, b.dtype))


def spmm_ref(a: torch.Tensor, b: EllMatrix) -> torch.Tensor:
    """(U_M U_K, U_N C_K) — EIE-like SpMM: ``for m; for n; for kB in
    pos(n)``. ``b`` holds column fibers (major_axis=1), ids indexing K."""
    assert b.major_axis == 1 and b.shape[0] == a.shape[1]
    acc = _acc_dtype(a.dtype, b.vals.dtype)
    safe = torch.where(b.ids >= 0, b.ids, 0).long()
    gathered = a.to(acc)[:, safe]                  # (M, N, C) = A[m, k(n,c)]
    out = (gathered * b.vals.to(acc)[None]).sum(dim=-1)
    return out.to(torch.promote_types(a.dtype, b.vals.dtype))


def spmm_mirror_ref(a: EllMatrix, b: torch.Tensor) -> torch.Tensor:
    """(U_M C_K, U_K U_N) — mirrored EIE-like SpMM (A compressed)."""
    assert a.major_axis == 0 and a.shape[1] == b.shape[0]
    acc = _acc_dtype(a.vals.dtype, b.dtype)
    safe = torch.where(a.ids >= 0, a.ids, 0).long()
    gathered = b.to(acc)[safe]                     # (M, C, N) = B[k(m,c), n]
    out = (gathered * a.vals.to(acc)[..., None]).sum(dim=1)
    return out.to(torch.promote_types(a.vals.dtype, b.dtype))


def spgemm_inner_ref(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """(U_M C_K, U_N C_K) — ExTensor-like inner-product SpGEMM: B densifies
    to ``(K, N)`` and A's coordinates gather the matching rows, so a K
    coordinate contributes exactly when both fibers hold it."""
    assert a.major_axis == 0 and b.major_axis == 1
    assert a.shape[1] == b.shape[0]
    acc = _acc_dtype(a.vals.dtype, b.vals.dtype)
    bd = _scatter_dense(b, acc).T                  # (K, N)
    live = a.ids >= 0
    safe = torch.where(live, a.ids, 0).long()
    av = torch.where(live, a.vals.to(acc), 0)
    out = torch.einsum("mc,mcn->mn", av, bd[safe])
    return out.to(torch.promote_types(a.vals.dtype, b.vals.dtype))


def spgemm_outer_ref(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """(U_K C_M, U_K C_N) — OuterSPACE-like outer-product SpGEMM: each K
    slice contributes the outer product of A's column fiber and B's row
    fiber; densified per fiber, their sum is one K contraction."""
    assert a.major_axis == 1 and b.major_axis == 0
    assert a.shape[1] == b.shape[0]
    acc = _acc_dtype(a.vals.dtype, b.vals.dtype)
    ea = _scatter_dense(a, acc)                    # (K, M)
    eb = _scatter_dense(b, acc)                    # (K, N)
    out = (ea[:, :, None] * eb[:, None, :]).sum(dim=0)
    return out.to(torch.promote_types(a.vals.dtype, b.vals.dtype))


def spgemm_gustavson_ref(a: EllMatrix, b: EllMatrix) -> torch.Tensor:
    """(U_K C_M, U_N C_K) — MatRaptor-like column-wise-product SpGEMM: for
    each output column n, stream B's column fiber; each nonzero ``B[k, n]``
    scales A's column fiber k (compressed over M). A scatters to a dense
    ``(K, M)`` table and B's coordinates gather its rows."""
    assert a.major_axis == 1 and b.major_axis == 1
    assert a.shape[1] == b.shape[0]
    acc = _acc_dtype(a.vals.dtype, b.vals.dtype)
    ea = _scatter_dense(a, acc)                    # (K, M)
    live = b.ids >= 0
    safe = torch.where(live, b.ids, 0).long()
    cols = ea[safe]                                # (N, C, M)
    bv = torch.where(live, b.vals.to(acc), 0)
    out = (cols * bv[..., None]).sum(dim=1).T
    return out.to(torch.promote_types(a.vals.dtype, b.vals.dtype))
