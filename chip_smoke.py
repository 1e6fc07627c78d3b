#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero,
so a run that prints the final ``{"ok": true, ...}`` line passed all:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card and power limit.
   Search ``dse.aespa_opt()`` (the paper's searched design) and print its
   clusters and the search's wall time.
2. Hold each kernel against its plain PyTorch version on the card, at every
   launch shape the main paths of phases 3 to 3f give it (each shape
   once) and on edge cases (ragged GEMM and Gustavson dims, empty fiber
   blocks and windows, a fiber at exactly its capacity, a K tile live on
   one side only, fibers whose live slots are out of order, both bodies
   forced on one pair, bfloat16; the Gustavson ones against the dense
   oracle ``ref.spgemm_gustavson_ref``; for the outer product also an
   all-zero A, whose output must be all zero, an M tile with 37 live K
   fibers, a dense A against a sparse B, and a dense B; for the chunked
   rank-update kernel of the SpMM, inner and Gustavson reference bodies an
   id out of range in a middle and in the last fiber, K not a multiple of
   its 32-wide chunk, mirrored SpMM rows not 16-byte aligned, an M tile
   with 37 live k, B fibers dense, ordered and out of order against
   contiguous and scattered live k, and a far gap in the live k; for the
   SpMM sparse body M not a multiple of the rows a block holds, a K long
   enough for the K-window walk, every fiber block empty, live slots
   shuffled, an id out of range and a small M whose launch splits N; for
   the inner sparse body B's fibers dense, ordered and shuffled, a B fiber
   at capacity, an empty row block, a K-window walk, few A rows against
   many B fibers and the reverse, and ragged M and N; for the Gustavson
   sparse body A's fibers dense, ordered and out of order, M over one
   1024-wide chunk, an all-zero A, B's slots shuffled and with a PAD slot
   inside the live range, and ragged M, K and N; for the GEMM a K not a
   multiple of its 32-wide step and a grid whose tail wave is split along
   K), with the kernel's, the plain version's and
   ``torch.matmul``'s times (CUDA events, median after warm-up; one timing
   for a call over 100 ms) beside the least time the card could take. The
   body "auto" passed over is timed too. Each SpMM, inner, Gustavson,
   outer and GEMM call, both bodies, must give the same bits twice and
   make no host sync (PyTorch's sync debug mode), and a profile gives each
   kernel's time without its wrapper's pre-pass (the row walk of the SpMM
   and inner sparse bodies, the row merge of the outer and Gustavson
   sparse bodies, the outer reference body, the chunked kernel of the
   three reference bodies and the GEMM) at every launch shape. The fiber
   scan those bodies run before their rank update is held against its
   plain versions (kinds, chunk starts, live groups).
3. The single-kernel path: ``schedule_single_kernel(aespa_equal4())`` then
   ``execute_schedule`` on the card for the nine Table I workloads (and
   citeseer reduced so that the outer product's sparse body runs), each
   against a float64 dense product on the card.
   3b. Each workload once more under ``torch.profiler``: wall, device busy
   time and device time by kernel name (where the time goes).
   3c. The many-kernel path on the same operands:
   ``schedule_many_kernels(aespa_equal4(), Table I)`` and
   ``execute_many_kernel_schedule`` under ``lpt`` (synthetic_dense whole on
   the GEMM), ``sjf`` and ``affinity`` (m3plates and speech on the outer
   product), ``hetero_many_matmul`` on two synthetic_dense tasks under
   ``optimized`` (the second split into SpMM k[0:2500] and outer
   k[2500:5000], a K-split merge), and the Table I queue on ``aespa_opt``
   under ``lpt`` (with bibd_81_3 reduced, six tasks whole on the Gustavson
   cluster and gnmt on the inner product; at Table I's dims gnmt goes to
   Gustavson); every task against float64. Then each of these runs once
   more under ``torch.profiler``.
   3d. The single-kernel path on ``aespa_opt`` for the nine Table I
   workloads, on the same operands, each against float64 (Gustavson
   partitions at synthetic_dense, speech and gnmt, citeseer whole), then
   each once more under ``torch.profiler``.
   3e. The stream executor on the same operands, from the host: the Table I
   queue under ``lpt`` on ``aespa_opt`` through
   ``execute_many_kernel_schedule(mesh=StreamMesh(8), pipeline_depth=2,
   measure=True)``, each cluster's partitions on its own CUDA streams;
   every output must be the same bits as phase 3c's sequential output of
   the task. A first (cold) run, then the measured one: wall (beside the
   sequential path's from the same host operands), peak memory, each
   cluster's measured busy ms, the measured
   makespan and ``measured_spatial_speedup``; each cluster's share of the
   first batch alone on the same lanes (its busy beside its busy in the
   batch); then one run under ``torch.profiler`` (device busy share).
   3f. Serving: ``ClusterServer(aespa_opt, policy="optimized").serve(
   mesh=StreamMesh(8), pipeline_depth=2, measure=True)`` on an
   18-request, 3-tenant trace (each of the nine workloads twice, phase 3's
   operands; arrivals and SLAs as ``examples/serve_cluster.py`` builds
   them). Every response within ``1e-4`` relative of a float64 product,
   the same bits as the same server's ``mesh=None`` serve, and the
   placements, p99 wait and busy fractions equal to an offline
   ``schedule_many_kernels(..., arrivals=admitted)``; after a first (cold)
   serve, the measured one's wall (beside the ``mesh=None`` serve's), peak
   memory and measured per-cluster busy, then one run under
   ``torch.profiler``.
4. A ``{"kernels": [...]}`` line with every kernel's launches on the main
   paths of phases 3, 3c, 3d, 3e and 3f (each must be > 0; the counts are
   set to 0 before each phase and read after it) and the numbers of
   phase 2, whose launch shapes include the serving schedule's.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch  # noqa: E402
from repro_torch.core import dse, scheduler  # noqa: E402
from repro_torch.core import hetero_matmul as hm  # noqa: E402
from repro_torch.core.stream_exec import (  # noqa: E402
    StreamMesh,
    aggregate_timelines,
)
from repro_torch.core.workloads import BY_NAME, Workload, synthesize  # noqa: E402
from repro_torch.formats import ell  # noqa: E402
from repro_torch.formats.taxonomy import DataflowClass  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import spgemm_gustavson as gust_mod  # noqa: E402
from repro_torch.kernels import spgemm_inner as inner_mod  # noqa: E402
from repro_torch.kernels import spgemm_outer as outer_mod  # noqa: E402
from repro_torch.kernels import spmm as spmm_mod  # noqa: E402
from repro_torch.serve import cluster  # noqa: E402

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the f32
#: rate of the CUDA cores, the units the ported kernels compute on.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: Tolerances of the JAX package's kernel tests (tests/test_kernels.py:
#: f32 1e-4, bf16 2e-2), applied normwise: max |err| <= tol·max(1, max |ref|).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: (label, Table I workload, max_elems for ``synthesize``). The nine Table
#: I workloads run at Table I size except bibd_81_3, which synthesize
#: reduces to 613x16288x8240 (its full B is 14.6 GB dense). The last is
#: citeseer reduced to 683x683x766: the only size at which a Table I
#: partition's outer-product tables fit the sparse body's 8 MiB "auto"
#: budget. Phase 3c's queue is the first nine, in Table I order.
MAIN_PATH = (
    ("chem97ZtZ", "chem97ZtZ", 1 << 27),
    ("journals", "journals", 1 << 27),
    ("m3plates", "m3plates", 1 << 27),
    ("synthetic_dense", "synthetic_dense", 1 << 27),
    ("bibd_81_3", "bibd_81_3", 1 << 27),
    ("speech", "speech", 1 << 27),
    ("gnmt", "gnmt", 1 << 27),
    ("transformer", "transformer", 1 << 27),
    ("citeseer", "citeseer", 1 << 27),
    ("citeseer_683", "citeseer", 1 << 19),
)
N_QUEUE = 9
BLOCK = 128  # the executors' default block
#: Phases 3e and 3f: a StreamMesh of 8 lanes, the device count of the JAX
#: package's sharded tests (8 forced host devices).
N_LANES = 8
TENANTS = ("tenant_a", "tenant_b", "tenant_c")

REPLACES = {
    "spmm_sparse": ("src/repro_torch/kernels/csrc/spmm.cu",
                    "src/repro/kernels/spmm.py:78"),
    "spmm_reference": ("src/repro_torch/kernels/csrc/spmm.cu",
                       "src/repro/kernels/spmm.py:42"),
    "outer_reference": ("src/repro_torch/kernels/csrc/spgemm_outer.cu",
                        "src/repro/kernels/spgemm_outer.py:45"),
    "outer_sparse": ("src/repro_torch/kernels/csrc/spgemm_outer.cu",
                     "src/repro/kernels/spgemm_outer.py:96"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:19"),
    "inner_sparse": ("src/repro_torch/kernels/csrc/spgemm_inner.cu",
                     "src/repro/kernels/spgemm_inner.py:114"),
    "inner_reference": ("src/repro_torch/kernels/csrc/spgemm_inner.cu",
                        "src/repro/kernels/spgemm_inner.py:49"),
    "gustavson_sparse": ("src/repro_torch/kernels/csrc/spgemm_gustavson.cu",
                         "src/repro/kernels/spgemm_gustavson.py:101"),
    "gustavson_reference": (
        "src/repro_torch/kernels/csrc/spgemm_gustavson.cu",
        "src/repro/kernels/spgemm_gustavson.py:47"),
}
COUNTERS = (spmm_mod.launches, outer_mod.launches, gemm_mod.launches,
            inner_mod.launches, gust_mod.launches)
#: The kernel each body launches, by the name its profile events carry:
#: the time of the kernel alone, without its wrapper's pre-pass, is taken
#: from a profile of the call.
KERNEL_NAMES = {
    "spmm_sparse": "row_walk_kernel",
    "inner_sparse": "row_walk_kernel",
    "gemm": "gemm_kernel",
    "outer_reference": "outer_reference_kernel",
    "outer_sparse": "row_merge_kernel",
    "gustavson_sparse": "row_merge_kernel",
    "spmm_reference": "chunk_update_kernel",
    "inner_reference": "chunk_update_kernel",
    "gustavson_reference": "chunk_update_kernel",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up run; a call whose warm-up took over 100 ms is timed once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > 100.0:
        reps = 1
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_run(fn, top: int = 6) -> dict:
    """One run of ``fn`` under ``torch.profiler``: wall ms (host clock,
    ending in a synchronize), the device's busy ms (union of its kernel,
    copy and memset intervals), and device ms by name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = e.time_range
        spans.append((r.start, r.end))
        name = e.name.split("(")[0].replace("void ", "")[:70]
        by_name[name] = by_name.get(name, 0.0) + (r.end - r.start) / 1e3
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_events": len(spans),
            "top_device_ms": [[n, ms] for n, ms in ranked[:top]]}


def no_sync_call(fn):
    """``fn()`` under PyTorch's sync debug mode: its result and where it
    made a host sync (``.item()``, ``nonzero``, a copy to the host, ...),
    each as the innermost Python frames of the warning."""
    import traceback
    import warnings

    syncs = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[-7:-1]
            syncs.append(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in reversed(stack)))

    torch.cuda.synchronize()
    # Switching the mode on warns once by itself: only fn() is watched.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, syncs


def kernel_only_ms(call, kernel_names, tries: int = 3) -> float:
    """Device ms of the one kernel whose name holds one of
    ``kernel_names`` that ``call`` launches, without its wrapper's
    pre-pass, from a profile of the call. The profiler now and then drops
    a kernel event (once in seven calls of one profile), so a profile that
    does not show exactly one is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [e.time_range for e in events
                 if any(n in e.name for n in kernel_names)]
        if len(spans) == 1:
            return (spans[0].end - spans[0].start) / 1e3
        seen = [e.name[:60] for e in events]
    raise AssertionError(f"profile: not one kernel of {kernel_names} in "
                         f"{tries} profiles (the last: {seen})")


class KernelCase:
    """One kernel call at fixed operands: the kernel, its plain version,
    the library yardstick, and the work the data needs. ``other`` is
    ``(name, call)`` of the body "auto" did not pick, or None."""

    def __init__(self, body, label, kernel, plain, library,
                 in_bytes, out_bytes, flops, dtype, other=None,
                 repeat=False, want_zero=False):
        self.body, self.label = body, label
        self.kernel, self.plain, self.library = kernel, plain, library
        self.other = other
        self.bound_ms, self.bound_by = bound(in_bytes + out_bytes, flops)
        self.dtype = dtype
        self.repeat, self.want_zero = repeat, want_zero

    def check(self, reps: int = 0) -> dict:
        """Error against the plain version (and, with ``reps``, the times);
        with ``repeat``, each body must give the same bits twice and make
        no host sync; with ``want_zero``, the kernel's output must be all
        zero."""
        want = self.plain()
        tol = TOL[str(self.dtype).replace("torch.", "")]
        got = self.kernel()
        err = self._error(got, want)
        row = {"name": self.body, "case": self.label, "max_abs_err": err,
               "tol": tol, "bound_ms": self.bound_ms,
               "bound_by": self.bound_by}
        bad = [self.body] if err is None else []
        if self.want_zero and bool(got.any()):
            bad.append(self.body + " (output not all zero)")
        if self.repeat:
            calls = [(self.body, self.kernel, got)]
            if self.other is not None:
                calls.append((*self.other, None))
            for name, call, first in calls:
                first = call() if first is None else first
                again, syncs = no_sync_call(call)
                if not torch.equal(first, again):
                    bad.append(name + " (two runs differ)")
                if syncs:
                    bad.append(f"{name} (host syncs at {syncs})")
        del got
        if reps:
            row["ms"] = time_ms(self.kernel, reps)
            row["plain_ms"] = time_ms(self.plain, max(1, reps // 2))
            row["library_ms"] = time_ms(self.library, reps)
            if self.other is not None:  # the body "auto" passed over
                name, call = self.other
                row["other_body"] = name
                row["other_max_abs_err"] = self._error(call(), want)
                row["other_ms"] = time_ms(call, reps)
                if row["other_max_abs_err"] is None:
                    bad.append(name)
        log("kernel " + json.dumps(row))
        if bad:
            raise AssertionError(f"{bad} ({self.label}) failed: against "
                                 "the plain version unless noted")
        return row

    def _error(self, got, want):
        """max |got - want|, or None when it fails the normwise check:
        kernel and plain version add up to K products in different orders,
        so an element that cancels to near zero keeps the rounding error
        of its large partial sums."""
        torch.cuda.synchronize()
        tol = TOL[str(self.dtype).replace("torch.", "")]
        gf, wf = got.float(), want.float()
        if not got.numel():
            return 0.0
        err = float((gf - wf).abs().max())
        scale = float(wf.abs().max())
        ok = bool(torch.isfinite(gf).all()) and err <= tol * max(1.0, scale)
        return err if ok else None


def other_body(name, call, both):
    """``(name, call)`` of the body "auto" passed over, or None for a case
    that holds one body alone (an operand outside the other's domain)."""
    return (name, call) if both else None


def spmm_case(label, ap, bp, bn, method="auto", both=True, want_zero=False):
    chosen = spmm_mod.resolve_method(method, ap.shape[1], bp.cap)
    other = "reference" if chosen == "sparse" else "sparse"
    b_dense = ell.ell_to_dense(bp).to(ap.dtype)
    m, n = ap.shape[0], bp.shape[1]
    nnz = int(((bp.ids >= 0) & (bp.ids < ap.shape[1])).sum())
    return KernelCase(
        "spmm_" + chosen, label,
        kernel=lambda: spmm_mod.spmm(ap, bp, bn=bn, method=chosen),
        plain=lambda: spmm_mod.spmm_plain(ap, bp),
        library=lambda: torch.matmul(ap, b_dense),
        in_bytes=nbytes(ap, bp.vals, bp.ids),
        out_bytes=m * n * ap.element_size(),
        flops=2.0 * m * nnz, dtype=ap.dtype,
        other=other_body("spmm_" + other,
                         lambda: spmm_mod.spmm(ap, bp, bn=bn, method=other),
                         both),
        repeat=True, want_zero=want_zero)


def outer_case(label, ap, bp, bm, bn, method="auto", want_zero=False):
    m, k = ap.shape
    n = bp.shape[1]
    chosen = outer_mod.resolve_method(method, m, k, n)
    other = "reference" if chosen == "sparse" else "sparse"
    a_dense = ell.ell_to_dense(ap)
    b_dense = ell.ell_to_dense(bp)
    pairs = float(((ap.ids >= 0).sum(1).double()
                   * (bp.ids >= 0).sum(1).double()).sum())
    return KernelCase(
        "outer_" + chosen, label,
        kernel=lambda: outer_mod.spgemm_outer(ap, bp, bm=bm, bn=bn,
                                              method=chosen),
        plain=lambda: outer_mod.spgemm_outer_plain(ap, bp),
        library=lambda: torch.matmul(a_dense, b_dense),
        in_bytes=nbytes(ap.vals, ap.ids, bp.vals, bp.ids),
        out_bytes=m * n * ap.vals.element_size(),
        flops=2.0 * pairs, dtype=ap.vals.dtype,
        other=("outer_" + other,
               lambda: outer_mod.spgemm_outer(ap, bp, bm=bm, bn=bn,
                                              method=other)),
        repeat=True, want_zero=want_zero)


def gemm_case(label, ap, bp, dims=None):
    """``ap @ bp``; the bound counts the work of the ``dims = (m, k, n)``
    the data has (default: the operands' own), not the zero padding the
    ops layer adds to match the JAX package's launch shapes."""
    m, k, n = dims or (*ap.shape, bp.shape[1])
    size = ap.element_size()
    return KernelCase(
        "gemm", label,
        kernel=lambda: gemm_mod.gemm(ap, bp),
        plain=lambda: gemm_mod.gemm_plain(ap, bp),
        library=lambda: torch.matmul(ap, bp),
        in_bytes=(m * k + k * n) * size, out_bytes=m * n * size,
        flops=2.0 * m * k * n, dtype=ap.dtype, repeat=True)


def inner_case(label, ap, bp, bm, bn, bk=BLOCK, method="auto", both=True):
    (m, k), n = ap.shape, bp.shape[1]
    chosen = inner_mod.resolve_method(method, k, ap.cap)
    other = "reference" if chosen == "sparse" else "sparse"
    a_dense = ell.ell_to_dense(ap)
    b_dense = ell.ell_to_dense(bp)
    # The products the data needs: a pair per K coordinate both hold.
    per_k = [torch.bincount(e.ids[(e.ids >= 0) & (e.ids < k)].long(),
                            minlength=k).double() for e in (ap, bp)]
    pairs = float((per_k[0] * per_k[1]).sum())
    return KernelCase(
        "inner_" + chosen, label,
        kernel=lambda: inner_mod.spgemm_inner(ap, bp, bm=bm, bn=bn, bk=bk,
                                              method=chosen),
        plain=lambda: inner_mod.spgemm_inner_plain(ap, bp),
        library=lambda: torch.matmul(a_dense, b_dense),
        in_bytes=nbytes(ap.vals, ap.ids, bp.vals, bp.ids),
        out_bytes=m * n * ap.vals.element_size(),
        flops=2.0 * pairs, dtype=ap.vals.dtype,
        other=other_body("inner_" + other,
                         lambda: inner_mod.spgemm_inner(
                             ap, bp, bm=bm, bn=bn, bk=bk, method=other),
                         both),
        repeat=True)


def gustavson_case(label, ap, bp, bm, bn, bk=BLOCK, method="auto",
                   plain=None, both=True):
    """``plain`` defaults to the module's plain version; the edge cases
    pass the dense oracle ``ref.spgemm_gustavson_ref`` instead, which
    gathers an (N, cap, M) block and so only suits small operands."""
    m, k = ap.shape
    n = bp.shape[1]
    chosen = gust_mod.resolve_method(method, k, bp.cap)
    other = "reference" if chosen == "sparse" else "sparse"
    a_dense = ell.ell_to_dense(ap)
    b_dense = ell.ell_to_dense(bp)
    # The products the data needs: a pair per K coordinate both hold (A's
    # fiber k against B's entries at k).
    per_k_b = torch.bincount(bp.ids[(bp.ids >= 0) & (bp.ids < k)].long(),
                             minlength=k)
    a_live = ((ap.ids >= 0) & (ap.ids < m)).sum(1).double()
    pairs = float((a_live * per_k_b.double()).sum())
    return KernelCase(
        "gustavson_" + chosen, label,
        kernel=lambda: gust_mod.spgemm_gustavson(ap, bp, bm=bm, bn=bn, bk=bk,
                                                 method=chosen),
        plain=plain or (lambda: gust_mod.spgemm_gustavson_plain(ap, bp)),
        library=lambda: torch.matmul(a_dense, b_dense),
        in_bytes=nbytes(ap.vals, ap.ids, bp.vals, bp.ids),
        out_bytes=m * n * ap.vals.element_size(),
        flops=2.0 * pairs, dtype=ap.vals.dtype,
        other=other_body("gustavson_" + other,
                         lambda: gust_mod.spgemm_gustavson(
                             ap, bp, bm=bm, bn=bn, bk=bk, method=other),
                         both),
        repeat=True)


def region_tag(label, p):
    r = p.region
    return (f"{label} [{r.m0}:{r.m1},{r.k0}:{r.k1},{r.n0}:{r.n1}] "
            f"{p.cls.value}{' mirror' if p.mirror else ''}")


def launch_key(cls, *operands):
    """What fixes a kernel launch: the class, and each operand's shape and,
    for a fiber operand, its capacity (block sizes are the executor's)."""
    return (cls,) + tuple(
        (tuple(x.shape), x.cap) if isinstance(x, ell.EllMatrix)
        else tuple(x.shape) if isinstance(x, torch.Tensor) else x
        for x in operands)


def partition_cases(label, a_d, b_d, partitions, seen):
    """The kernel calls the executor makes for ``partitions``, built
    through the executor's own preparation and the ops layer's padding;
    a launch whose :func:`launch_key` is in ``seen`` is left out."""
    parts = [p for p in partitions if not p.region.empty]
    cases = []
    for p, sa, sb, caps in hm.prepare_partitions([(a_d, b_d, parts)])[0]:
        pa, pb = hm._prep_operands(p.cls, sa, sb, p.mirror, caps)
        tag = region_tag(label, p)
        if p.cls == DataflowClass.GEMM:
            operands = ops.gemm_operands(pa, pb, bm=BLOCK, bn=BLOCK,
                                         bk=BLOCK)
            make = lambda: gemm_case(tag, *operands,  # noqa: E731
                                     dims=(*pa.shape, pb.shape[1]))
        elif p.cls == DataflowClass.SPMM:
            prep = (ops.spmm_mirror_operands if p.mirror
                    else ops.spmm_operands)
            operands = prep(pa, pb, bm=BLOCK, bn=BLOCK)
            make = lambda: spmm_case(tag, *operands)  # noqa: E731
        elif p.cls == DataflowClass.SPGEMM_INNER:
            operands = ops.spgemm_inner_operands(pa, pb, bm=BLOCK, bn=BLOCK,
                                                 bk=BLOCK)
            make = lambda: inner_case(tag, *operands)  # noqa: E731
        elif p.cls == DataflowClass.SPGEMM_OUTER:
            operands = ops.spgemm_outer_operands(pa, pb, bm=BLOCK, bn=BLOCK,
                                                 bk=BLOCK)
            make = lambda: outer_case(tag, *operands)  # noqa: E731
        else:
            operands = ops.spgemm_gustavson_operands(pa, pb, bm=BLOCK,
                                                     bn=BLOCK, bk=BLOCK)
            make = lambda: gustavson_case(tag, *operands)  # noqa: E731
        key = launch_key(p.cls, *operands)
        if key not in seen:
            seen.add(key)
            cases.append(make())
    return cases


def edge_cases():
    """Small operands built to hit the kernels' edges, in float32 and
    bfloat16: an all-zero fiber block (SpMM, inner, Gustavson) or window
    (outer, Gustavson), an all-zero A block (inner), a fiber at exactly its
    capacity, K tiles live on one side only (inner), ragged GEMM dims and
    ragged Gustavson M, K and N, live slots out of order (inner, outer,
    Gustavson), an all-zero A, an M tile whose live-K count is not a
    multiple of the kernel's chunk, a dense A against a sparse B and a
    dense B (outer), and both bodies of each sparse kernel forced on one
    operand pair."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def sparse(r, c, density):
        x = torch.randn(r, c, device="cuda", generator=gen)
        return x * (torch.rand(r, c, device="cuda", generator=gen) < density)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        # GEMM: ragged through the ops padding, and ragged into the kernel
        # itself (its tiles mask the edges).
        a = sparse(200, 300, 1.0).to(dtype)
        b = sparse(300, 130, 1.0).to(dtype)
        cases.append(gemm_case(f"edge {name} padded",
                               *ops.gemm_operands(a, b), dims=(200, 300, 130)))
        cases.append(gemm_case(f"edge {name} ragged 200x300x130", a, b))
        # SpMM: B columns 128..255 empty (a dead fiber block at bn=128);
        # column 3 holds exactly cap=16 nonzeros, the most of any column.
        a = sparse(200, 300, 1.0).to(dtype)
        b = sparse(300, 384, 0.01)
        b[:, 128:256] = 0
        b[:, 3] = 0
        b[torch.arange(0, 300, 19)[:16], 3] = 1.5
        b_ell = ell.dense_to_ell(b.to(dtype), 1, 16, strict=True)
        for method in ("sparse", "reference"):
            ap, bp, bn = ops.spmm_operands(a, b_ell, bm=128, bn=128)
            cases.append(spmm_case(f"edge {name}", ap, bp, bn, method))
        # Inner: A rows 128..255 empty (a dead M block); A's k[0:128] empty
        # for rows 0..127 while B holds entries there, and B's k[256:384]
        # empty while A holds entries there (one side live); B columns
        # 128..255 empty (a dead N block); row 5 of A at exactly cap=32.
        a = sparse(300, 384, 0.03)
        a[128:256, :] = 0
        a[:128, :128] = 0
        a[5, :] = 0
        a[5, torch.arange(128, 384, 8)] = -1.25
        b = sparse(384, 384, 0.05)
        b[256:, :] = 0
        b[:, 128:256] = 0
        a_ell = ell.dense_to_ell(a.to(dtype), 0, 32, strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 1,
                                 int((b != 0).sum(0).max()), strict=True)
        for method in ("sparse", "reference"):
            ap, bp, bm, bn = ops.spgemm_inner_operands(a_ell, b_ell, bm=128,
                                                       bn=128)
            cases.append(inner_case(f"edge {name}", ap, bp, bm, bn,
                                    method=method))
        # The same pair with each fiber's live slots shuffled (ids out of
        # order, PAD slots still last): both bodies must still agree.
        shuffled = [shuffle_live_slots(e, gen) for e in (ap, bp)]
        for method in ("sparse", "reference"):
            cases.append(inner_case(f"edge {name} shuffled", *shuffled, bm,
                                    bn, method=method))
        # Outer, each case with both bodies forced: A's M window 128..255
        # and B's N window 128..255 empty; fiber 5 of A exactly at cap.
        a = sparse(384, 260, 0.01)
        a[128:256, :] = 0
        a[:, 5] = 0
        a[torch.arange(0, 384, 23)[:16], 5] = -2.0
        b = sparse(260, 320, 0.05)
        b[:, 128:256] = 0
        a_ell = ell.dense_to_ell(a.to(dtype), 1, 16, strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 0,
                                 int((b != 0).sum(1).max()), strict=True)
        for method in ("sparse", "reference"):
            ap, bp, bm, bn = ops.spgemm_outer_operands(a_ell, b_ell, bm=128,
                                                       bn=128)
            cases.append(outer_case(f"edge {name}", ap, bp, bm, bn,
                                    method))
        # The same pair with live slots shuffled in both operands.
        shuffled = [shuffle_live_slots(e, gen) for e in (ap, bp)]
        for method in ("sparse", "reference"):
            cases.append(outer_case(f"edge {name} shuffled", *shuffled, bm,
                                    bn, method))
        # An all-zero A: the output must be all zero.
        zero_a = ell.dense_to_ell(torch.zeros(384, 260, dtype=dtype,
                                              device="cuda"), 1, 8)
        for method in ("sparse", "reference"):
            ap, bp, bm, bn = ops.spgemm_outer_operands(zero_a, b_ell, bm=128,
                                                       bn=128)
            cases.append(outer_case(f"edge {name} all-zero A", ap, bp, bm,
                                    bn, method, want_zero=True))
        # M tile 0 live in exactly 37 K fibers: a full chunk of 32 and a
        # ragged one of 5.
        a = sparse(384, 260, 0.01)
        a[:128, :] = 0
        a[torch.arange(37) * 3, torch.arange(37) * 7] = 0.75
        a_ell = ell.dense_to_ell(a.to(dtype), 1, int((a != 0).sum(0).max()),
                                 strict=True)
        ap, bp, bm, bn = ops.spgemm_outer_operands(a_ell, b_ell, bm=128,
                                                   bn=128)
        if int(outer_mod.live_k_lists(ap)[1][0]) != 37:
            raise AssertionError("outer edge case: M tile 0 not 37 live k")
        for method in ("sparse", "reference"):
            cases.append(outer_case(f"edge {name} 37 live k", ap, bp, bm, bn,
                                    method))
        # The sparse side is B, the dense side A: every k live in every M
        # tile, most chunks without a B entry in the window.
        a = sparse(384, 260, 1.0)
        b = sparse(260, 320, 0.01)
        a_ell = ell.dense_to_ell(a.to(dtype), 1, 384, strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 0,
                                 int((b != 0).sum(1).max()), strict=True)
        for method in ("sparse", "reference"):
            ap, bp, bm, bn = ops.spgemm_outer_operands(a_ell, b_ell, bm=128,
                                                       bn=128)
            cases.append(outer_case(f"edge {name} dense A, sparse B", ap, bp,
                                    bm, bn, method))
        # Dense B: every fiber's ids are its slots (one cut short), with PAD
        # slots after them from the capacity bucket; no window is searched.
        a = sparse(384, 260, 0.02)
        b = sparse(260, 320, 1.0)
        b[7, 100:] = 0
        a_ell = ell.dense_to_ell(a.to(dtype), 1, int((a != 0).sum(0).max()),
                                 strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 0, 320, strict=True)
        for method in ("sparse", "reference"):
            ap, bp, bm, bn = ops.spgemm_outer_operands(a_ell, b_ell, bm=128,
                                                       bn=128)
            cases.append(outer_case(f"edge {name} dense B", ap, bp, bm, bn,
                                    method))
        # Gustavson, each case against the dense oracle: ragged M, K and N
        # straight into the kernels (the blocks shrink to divide them).
        a = sparse(200, 260, 0.05)
        b = sparse(260, 130, 0.2)
        a_ell = ell.dense_to_ell(a.to(dtype), 1, int((a != 0).sum(0).max()),
                                 strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 1, int((b != 0).sum(0).max()),
                                 strict=True)
        for method in ("sparse", "reference"):
            cases.append(gustavson_case(
                f"edge {name} ragged 200x260x130", a_ell, b_ell, 128, 128,
                method=method, plain=gustavson_oracle(a_ell, b_ell)))
        # Through the ops padding: A's M window 128..255 empty, B's N block
        # 128..255 empty, A's fiber 5 and B's fiber 3 each exactly at
        # capacity 32 (the fullest fibers; 32 survives the bucketing).
        a = sparse(384, 300, 0.03)
        a[128:256, :] = 0
        a[:, 5] = 0
        a[torch.cat([torch.arange(0, 128, 8), torch.arange(256, 384, 8)]),
          5] = -1.75
        b = sparse(300, 384, 0.05)
        b[:, 128:256] = 0
        b[:, 3] = 0
        b[torch.arange(0, 300, 9)[:32], 3] = 1.25
        a_ell = ell.dense_to_ell(a.to(dtype), 1, 32, strict=True)
        b_ell = ell.dense_to_ell(b.to(dtype), 1, 32, strict=True)
        ap, bp, bm, bn = ops.spgemm_gustavson_operands(a_ell, b_ell, bm=128,
                                                       bn=128)
        if int(ap.lens[5]) != ap.cap or int(bp.lens[3]) != bp.cap:
            raise AssertionError("Gustavson edge case: fibers not at cap")
        for method in ("sparse", "reference"):
            cases.append(gustavson_case(f"edge {name}", ap, bp, bm, bn,
                                        method=method,
                                        plain=gustavson_oracle(ap, bp)))
        # The same pair with live slots shuffled in both operands.
        shuffled = [shuffle_live_slots(e, gen) for e in (ap, bp)]
        for method in ("sparse", "reference"):
            cases.append(gustavson_case(
                f"edge {name} shuffled", *shuffled, bm, bn, method=method,
                plain=gustavson_oracle(*shuffled)))
        cases += chunk_edge_cases(name, dtype, sparse, gen)
        cases += sparse_gemm_edge_cases(name, dtype, sparse, gen)
        cases += inner_sparse_edge_cases(name, dtype, sparse, gen)
        cases += gustavson_sparse_edge_cases(name, dtype, sparse, gen)
    return cases


def with_bad_id(e, where):
    """``e`` with the last live slot of its middle or last fiber holding an
    id past its minor size, beyond the discard bucket of 128-wide tiles
    (the fault of ``tile_occupancy`` fixed with the redesign): a reference
    body drops it, as the TPU's expansion does."""
    f = e.n_fibers // 2 if where == "middle" else e.n_fibers - 1
    ids = e.ids.clone()
    live = int((ids[f] >= 0).sum())
    if live == 0:
        raise AssertionError(f"edge case: fiber {f} holds no entry")
    ids[f, live - 1] = (-(-e.minor_size // BLOCK) + 1) * BLOCK + 5
    return ell.EllMatrix(e.vals, ids, e.lens, e.shape, e.major_axis)


def exact_ell(x, axis, dtype, cap=None):
    """``x`` in ``dtype`` as fibers along ``axis``, at ``cap`` slots or the
    capacity its fullest fiber needs (at least 1)."""
    need = int((x != 0).sum(dim=1 - axis).max())
    return ell.dense_to_ell(x.to(dtype), axis, cap or max(need, 1),
                            strict=True)


def chunk_edge_cases(name, dtype, sparse, gen):
    """Edge cases of the chunked rank-update kernel (the SpMM, inner and
    Gustavson reference bodies): an id out of range in a middle and in the
    last fiber (the reference body alone here: the SpMM sparse body's case
    is in :func:`sparse_gemm_edge_cases`, and the inner and Gustavson
    sparse bodies do not take such operands); K not a multiple of the
    32-wide chunk; mirrored SpMM rows not 16-byte aligned; an M tile with
    37 live k; B fibers dense, ordered and out of order against contiguous
    and scattered live k, and a far gap the kernel's binary search jumps;
    each with both bodies."""
    cases = []
    ells = functools.partial(exact_ell, dtype=dtype)
    a = sparse(200, 300, 1.0).to(dtype)
    b = sparse(300, 256, 0.3)
    for where in ("middle", "last"):
        ap, bp, bn = ops.spmm_operands(a, ells(b, 1), bm=BLOCK, bn=BLOCK)
        cases.append(spmm_case(f"edge {name} id out of range, {where} fiber",
                               ap, with_bad_id(bp, where), bn, "reference",
                               both=False))
        a2 = sparse(256, 300, 0.3)
        ap, bp, bm, bn = ops.spgemm_inner_operands(ells(a2, 0), ells(b, 1),
                                                   bm=BLOCK, bn=BLOCK)
        cases.append(inner_case(
            f"edge {name} id out of range, {where} fiber",
            with_bad_id(ap, where), with_bad_id(bp, where), bm, bn,
            method="reference", both=False))
        a3 = sparse(256, 384, 0.3)
        b3 = sparse(384, 256, 0.3)
        ap, bp, bm, bn = ops.spgemm_gustavson_operands(
            ells(a3, 1), ells(b3, 1), bm=BLOCK, bn=BLOCK)
        cases.append(gustavson_case(
            f"edge {name} id out of range, {where} fiber",
            with_bad_id(ap, where), with_bad_id(bp, where), bm, bn,
            method="reference", both=False))
    # K = 300 straight into the inner kernels, with ragged M and N.
    a2 = sparse(200, 300, 0.3)
    b2 = sparse(300, 130, 0.3)
    cases.append(inner_case(f"edge {name} K 300 ragged 200x300x130",
                            ells(a2, 0), ells(b2, 1), BLOCK, BLOCK,
                            method="reference"))
    # Mirrored SpMM: the dense operand's rows of 301 and 302 elements, not
    # 16-byte aligned, copied in narrower pieces (bf16 301: plain loads).
    for k in (301, 302):
        am = sparse(200, k, 0.3)
        bm_ = sparse(k, 150, 1.0).to(dtype)
        ap, bp, bn = ops.spmm_mirror_operands(ells(am, 0), bm_, bm=BLOCK,
                                              bn=BLOCK)
        if _build.row_granule(ap) * ap.element_size() >= 16:
            raise AssertionError("edge case: mirrored rows are aligned")
        cases.append(spmm_case(f"edge {name} mirror rows of {k}", ap, bp, bn,
                               "reference"))
    # M tile 0 live at exactly 37 k: a full chunk and one of 5.
    a2 = sparse(256, 300, 0.3)
    a2[:128] = 0
    a2[torch.arange(37) * 3, torch.arange(37) * 7] = 0.5
    ap, bp, bm, bn = ops.spgemm_inner_operands(ells(a2, 0), ells(b, 1),
                                               bm=BLOCK, bn=BLOCK)
    if int(inner_mod.live_k_rows(ap)[1][0]) != 37:
        raise AssertionError("edge case: M tile 0 not 37 live k")
    cases.append(inner_case(f"edge {name} 37 live k", ap, bp, bm, bn,
                            method="reference"))
    ap, bp, bm, bn = ops.spgemm_gustavson_operands(
        ells(a2[:, :256].contiguous(), 1), ells(b[:256], 1), bm=BLOCK,
        bn=BLOCK)
    cases.append(gustavson_case(f"edge {name} 37 live k", ap, bp, bm, bn,
                                method="reference"))
    # B's fiber kinds against contiguous (dense A) and scattered (sparse
    # A) live k; SpMM's scattered chunks come from a B live in some only.
    k = 300
    for kind, density in (("dense", 1.0), ("ordered", 0.3),
                          ("out of order", 0.3)):
        bk_ = sparse(k, 256, density)
        bk_[100:, 9] = 0           # a fiber cut short
        b_ell = ells(bk_, 1)
        if kind == "out of order":
            b_ell = shuffle_live_slots(b_ell, gen)
        for live, da in (("contiguous", 1.0), ("scattered", 0.01)):
            a2 = sparse(256, k, da)
            ap, bp, bm, bn = ops.spgemm_inner_operands(
                ells(a2, 0), b_ell, bm=BLOCK, bn=BLOCK)
            cases.append(inner_case(f"edge {name} B {kind}, {live} k", ap,
                                    bp, bm, bn, method="reference"))
            ap, bp, bm, bn = ops.spgemm_gustavson_operands(
                ells(a2, 1), b_ell, bm=BLOCK, bn=BLOCK)
            cases.append(gustavson_case(f"edge {name} B {kind}, {live} k",
                                        ap, bp, bm, bn, method="reference"))
        bs = bk_.clone()
        bs[32:64] = 0
        bs[128:192] = 0
        b_ell = ells(bs, 1)
        if kind == "out of order":
            b_ell = shuffle_live_slots(b_ell, gen)
        ap, bp, bn = ops.spmm_operands(sparse(200, k, 1.0).to(dtype), b_ell,
                                       bm=BLOCK, bn=BLOCK)
        cases.append(spmm_case(f"edge {name} B {kind}, scattered chunks",
                               ap, bp, bn, "reference"))
    # A far gap: A live at k < 32 and at 32 k near the end, B ordered and
    # dense enough that more than 32 of its slots lie in the gap.
    k = 600
    a2 = sparse(256, k, 0.5)
    a2[:, 32:k - 40] = 0
    a2[:, k - 8:] = 0
    b2 = sparse(k, 256, 0.6)
    for op in ("inner", "gustavson"):
        if op == "inner":
            ap, bp, bm, bn = ops.spgemm_inner_operands(
                ells(a2, 0), ells(b2, 1), bm=BLOCK, bn=BLOCK)
            cases.append(inner_case(f"edge {name} far gap", ap, bp, bm, bn,
                                    method="reference"))
        else:
            ap, bp, bm, bn = ops.spgemm_gustavson_operands(
                ells(a2, 1), ells(b2, 1), bm=BLOCK, bn=BLOCK)
            cases.append(gustavson_case(f"edge {name} far gap", ap, bp, bm,
                                        bn, method="reference"))
    return cases


def sparse_gemm_edge_cases(name, dtype, sparse, gen):
    """Edge cases of the SpMM sparse body and the GEMM, each against its
    plain version. SpMM sparse: M not a multiple of the rows a block
    holds, a K that takes the K-window walk, every fiber block empty (all
    zeros out), live slots shuffled, an id out of range in a middle and in
    the last fiber, and a small M whose launch needs the N split; each plan
    is checked to take the path it is meant for. GEMM: K not a multiple of
    the 32-wide K step, and a grid whose tail wave is split along K."""
    cases = []
    code = _build.dtype_code("edge case", dtype)
    elem = torch.empty((), dtype=dtype).element_size()

    ells = functools.partial(exact_ell, axis=1, dtype=dtype)

    def plan_of(m, k, n):
        return spmm_mod.spmm_sparse_plan(
            m, k, n, elem, lambda rows, smem: spmm_mod.block_slots(
                torch.device("cuda", 0), code, rows, smem))

    # M = 203 straight into the kernel: 16 rows a block, the last with 11.
    a = sparse(203, 300, 1.0).to(dtype)
    b_ell = ells(sparse(300, 384, 0.05))
    if 203 % plan_of(203, 300, 384).rows == 0:
        raise AssertionError("edge case: M a multiple of the block's rows")
    cases.append(spmm_case(f"edge {name} sparse M 203", a, b_ell, 128,
                           "sparse"))
    # Live slots out of order, PAD slots still last.
    cases.append(spmm_case(f"edge {name} sparse shuffled", a,
                           shuffle_live_slots(b_ell, gen), 128, "sparse"))
    # An id past K in a middle and in the last fiber: dropped.
    for where in ("middle", "last"):
        cases.append(spmm_case(
            f"edge {name} sparse id out of range, {where} fiber", a,
            with_bad_id(b_ell, where), 128, "sparse", both=False))
    # Every fiber block empty: the output is all zero.
    cases.append(spmm_case(f"edge {name} sparse all blocks empty", a,
                           ells(torch.zeros(300, 256, device="cuda"), cap=4),
                           128, "sparse", want_zero=True))
    # K = 50000: no row of A fits the block's shared memory whole.
    k = 50000
    if plan_of(130, k, 384).window >= k:
        raise AssertionError("edge case: K = 50000 fits without windows")
    cases.append(spmm_case(f"edge {name} sparse K windows",
                           sparse(130, k, 1.0).to(dtype),
                           ells(sparse(k, 384, 0.002)), 128, "sparse",
                           both=False))
    # M = 40 against 4096 fibers: three row blocks, the fibers split.
    if plan_of(40, 300, 4096).n_split < 2:
        raise AssertionError("edge case: the small-M launch is not split")
    cases.append(spmm_case(f"edge {name} sparse N split",
                           sparse(40, 300, 1.0).to(dtype),
                           ells(sparse(300, 4096, 0.05)), 128, "sparse"))
    # GEMM: K = 312 (rows 16-byte aligned, 24 past the last full K step).
    a = sparse(256, 312, 1.0).to(dtype)
    b = sparse(312, 256, 1.0).to(dtype)
    cases.append(gemm_case(f"edge {name} K 312", a, b))
    # GEMM: a grid of slots + 8 tiles, whose last 8 run split along K.
    slots = gemm_mod.block_slots(torch.device("cuda", 0), code)
    m = gemm_mod.GEMM_TILE_M * (-(-(slots + 8) // 4))
    plan = gemm_mod.gemm_plan(m, 1024, 4 * gemm_mod.GEMM_TILE_N, slots)
    if plan.splits < 2 or not plan.tail:
        raise AssertionError(f"edge case: no split tail ({plan})")
    a = sparse(m, 1024, 1.0).to(dtype)
    b = sparse(1024, 4 * gemm_mod.GEMM_TILE_N, 1.0).to(dtype)
    cases.append(gemm_case(f"edge {name} tail of {plan.tail} tiles in "
                           f"{plan.splits} pieces", a, b))
    return cases


def pad_inside(e):
    """``e`` with a PAD slot inside each fiber's live range: the live slot
    at half the fiber's live count swapped with the first PAD slot (a
    fiber with fewer than two live slots, or at capacity, keeps its
    slots); ``lens`` stays the live count."""
    ids, vals = e.ids.clone(), e.vals.clone()
    live = (ids >= 0).sum(dim=1)
    rows = torch.nonzero((live >= 2) & (live < e.cap)).flatten()
    if not rows.numel():
        raise AssertionError("edge case: no fiber to put a PAD slot inside")
    mid, end = live[rows] // 2, live[rows]
    for t in (ids, vals):
        t[rows, mid], t[rows, end] = t[rows, end].clone(), t[rows, mid].clone()
    return ell.EllMatrix(vals, ids, e.lens, e.shape, e.major_axis)


def inner_sparse_edge_cases(name, dtype, sparse, gen):
    """Edge cases of the inner sparse body (the row walk with B's fibers
    expanded into its rows), each with the sparse body forced and held
    against the plain version: B's fibers dense, ordered and with shuffled
    live slots; a B fiber at exactly its capacity; every B fiber of a row
    block empty; a K long enough for the K-window walk; few A rows against
    many B fibers and the reverse (no fiber split, then a split); M and N
    not multiples of the blocks. Each plan is checked to take the path it
    is meant for."""
    cases = []
    elem = torch.empty((), dtype=dtype).element_size()
    ells = functools.partial(exact_ell, dtype=dtype)
    sms = _build.sm_count(torch.device("cuda", 0))

    def plan_of(m, k, n):
        return inner_mod.inner_sparse_plan(m, k, n, elem, sms)

    def case(label, a, b, bm=BLOCK):
        return inner_case(f"edge {name} sparse {label}", ells(a, 0),
                          ells(b, 1), bm, BLOCK, method="sparse")

    a = sparse(256, 300, 0.02)
    for kind, density in (("dense", 1.0), ("ordered", 0.3)):
        b = sparse(300, 256, density)
        b[100:, 9] = 0                    # a fiber cut short
        cases.append(case(f"B {kind}", a, b))
        if kind == "ordered":
            ap, bp = ells(a, 0), shuffle_live_slots(ells(b, 1), gen)
            cases.append(inner_case(f"edge {name} sparse B shuffled", ap, bp,
                                    BLOCK, BLOCK, method="sparse"))
    # B's fiber 3 at exactly its capacity of 32, the fullest.
    b = sparse(300, 256, 0.05)
    b[:, 3] = 0
    b[torch.arange(0, 300, 9)[:32], 3] = 1.25
    bp = ells(b, 1, cap=32)
    if int(bp.lens[3]) != bp.cap:
        raise AssertionError("inner edge case: B's fiber 3 not at cap")
    cases.append(inner_case(f"edge {name} sparse B fiber at cap",
                            ells(a, 0), bp, BLOCK, BLOCK, method="sparse"))
    # B's fibers 0..63 empty: every row block there holds zeros.
    b = sparse(300, 256, 0.3)
    b[:, :64] = 0
    cases.append(case("B rows 0..63 empty", a, b))
    # A K window walk: no fiber of B fits a block's shared memory whole.
    k = 30000 if elem == 4 else 50000
    if plan_of(256, k, 130).window >= k:
        raise AssertionError(f"inner edge case: K = {k} fits without "
                             "windows")
    cases.append(case(f"K {k} windows", sparse(256, k, 0.002),
                      sparse(k, 130, 0.3)))
    # Few A rows against many B fibers: row blocks fill the card, no split;
    # the reverse: few row blocks, A's fibers split.
    if plan_of(40, 300, 4096).n_split != 1:
        raise AssertionError("inner edge case: 4096 B fibers split")
    cases.append(case("40 A rows x 4096 B fibers", sparse(40, 300, 0.05),
                      sparse(300, 4096, 0.3), bm=8))
    if plan_of(4096, 300, 40).n_split < 2:
        raise AssertionError("inner edge case: 4096 A rows not split")
    cases.append(case("4096 A rows x 40 B fibers", sparse(4096, 300, 0.05),
                      sparse(300, 40, 0.3)))
    # M = 203 and N = 130 straight into the kernel (bm shrinks to 1; the
    # last row block ragged).
    cases.append(case("ragged 203x300x130", sparse(203, 300, 0.03),
                      sparse(300, 130, 0.3)))
    return cases


def gustavson_sparse_edge_cases(name, dtype, sparse, gen):
    """Edge cases of the Gustavson sparse body (the row merge with B's
    fibers read in place), each with the sparse body forced and held
    against the plain version: A's fibers dense, ordered and out of order;
    M > 1024 with a ragged last M chunk; an all-zero A (the output must be
    all zero); B's fibers with shuffled slots and with a PAD slot inside
    the live range; ragged M, K and N."""
    cases = []
    ells = functools.partial(exact_ell, dtype=dtype)

    def case(label, ap, bp, want_zero=False):
        c = gustavson_case(f"edge {name} sparse {label}", ap, bp, BLOCK,
                           BLOCK, method="sparse")
        c.want_zero = want_zero
        return c

    b = sparse(300, 256, 0.05)
    for kind, density in (("dense", 1.0), ("ordered", 0.3),
                          ("out of order", 0.3)):
        a = sparse(384, 300, density)
        a[100:, 9] = 0                    # a fiber cut short
        ap = ells(a, 1)
        if kind == "out of order":
            ap = shuffle_live_slots(ap, gen)
        cases.append(case(f"A {kind}", ap, ells(b, 1)))
    # M = 2100: two whole M chunks of 1024 and one of 52.
    cases.append(case("M 2100", ells(sparse(2100, 300, 0.02), 1),
                      ells(b, 1)))
    # An all-zero A.
    zero_a = ell.dense_to_ell(torch.zeros(384, 300, dtype=dtype,
                                          device="cuda"), 1, 8)
    cases.append(case("all-zero A", zero_a, ells(b, 1), want_zero=True))
    # B's live slots shuffled, then a PAD slot inside each live range.
    ap = ells(sparse(384, 300, 0.1), 1)
    bp = shuffle_live_slots(ells(b, 1), gen)
    cases.append(case("B shuffled", ap, bp))
    cases.append(case("B PAD inside", ap, pad_inside(ells(b, 1))))
    cases.append(case("B shuffled, PAD inside", ap, pad_inside(bp)))
    # Ragged M, K and N straight into the kernel, M over one chunk.
    cases.append(case("ragged 1100x261x133",
                      ells(sparse(1100, 261, 0.05), 1),
                      ells(sparse(261, 133, 0.05), 1)))
    return cases


def scan_check(label, e, tile, group):
    """The fiber scan that the SpMM, inner and Gustavson reference
    launches run before their rank update (``fiber_scan_launch``), held
    against its plain versions on ``e``: the kinds (out of order where
    ``spgemm_inner._ordered`` says so, dense where the live ids are the
    slots, else ordered), every ordered fiber's chunk starts
    (``spgemm_outer.fiber_chunk_starts``) and each tile's live groups
    (``spgemm_outer.tile_live_lists``). Raises on a difference."""
    lib = _build.load("spgemm_inner", inner_mod._SIGNATURES)
    nf, cap, minor = e.n_fibers, e.cap, e.minor_size
    chunk = spmm_mod.REFERENCE_CHUNK
    n_groups = -(-minor // group)
    kinds = torch.empty(nf, dtype=torch.int32, device="cuda")
    starts = torch.empty((-(-minor // chunk) + 1, nf), dtype=torch.int32,
                         device="cuda")
    flags = torch.zeros((-(-nf // tile), n_groups), dtype=torch.uint8,
                        device="cuda")
    _build.check(lib.fiber_scan_launch(
        _build.ptr(e.ids), nf, cap, minor, _build.ptr(kinds),
        _build.ptr(starts), chunk, _build.ptr(flags), tile, group,
        _build.stream(e.ids.device)), "fiber_scan")
    ordered = inner_mod._ordered(e)
    live = e.ids >= 0
    slots = torch.arange(cap, device="cuda", dtype=e.ids.dtype)
    dense = ordered & ((e.ids == slots) | ~live).all(dim=1)
    want_kind = torch.where(~ordered, -2, torch.where(
        dense, live.sum(dim=1, dtype=torch.int32), -1)).to(torch.int32)
    want_starts = outer_mod.fiber_chunk_starts(e, chunk)
    lists, counts = outer_mod.tile_live_lists(e, tile, group)
    in_list = (torch.arange(n_groups + 1, device="cuda")[None]
               < counts[:, None])
    want_flags = torch.zeros((lists.shape[0], n_groups + 1),
                             dtype=torch.uint8, device="cuda")
    want_flags.scatter_(1, torch.where(in_list, lists, n_groups).long(), 1)
    bad = [what for what, ok in (
        ("kinds", torch.equal(kinds, want_kind)),
        ("starts", torch.equal(starts[:, ordered], want_starts[:, ordered])),
        ("flags", torch.equal(flags, want_flags[:, :n_groups]))) if not ok]
    log(f"scan {label}: tile {tile}, group {group}, {int(ordered.sum())} of "
        f"{nf} fibers ordered, {int(dense.sum())} dense: "
        + ("ok" if not bad else f"differs in {bad}"))
    if bad:
        raise AssertionError(f"fiber scan ({label}) differs from its plain "
                             f"versions in {bad}")


def scan_checks():
    """:func:`scan_check` on fibers dense, ordered, out of order and with
    ids out of range, at SpMM's live chunks (group 32) and inner's live k
    (group 1), with a ragged last tile."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, density in (("dense", 1.0), ("ordered", 0.3),
                           ("sparse", 0.01)):
        x = torch.randn(300, 200, device="cuda", generator=gen)
        x = x * (torch.rand(300, 200, device="cuda", generator=gen)
                 < density)
        x[:, 7] = 0
        e = ell.dense_to_ell(x, 1, int((x != 0).sum(0).max()) + 3)
        variants = [(label, e), (label + " shuffled",
                                 shuffle_live_slots(e, gen))]
        if density < 1.0:
            variants.append((label + " id out of range",
                             with_bad_id(e, "middle")))
        for name, f in variants:
            for group in (spmm_mod.REFERENCE_CHUNK, 1):
                scan_check(name, f, BLOCK, group)


def gustavson_oracle(ap, bp):
    return lambda: ref.spgemm_gustavson_ref(ap, bp)


def shuffle_live_slots(e, gen):
    """``e`` with each fiber's live slots in random order (PAD slots stay
    last, as ELL keeps them): the kernels' scan path for fibers out of
    order."""
    key = torch.rand(e.ids.shape, device="cuda", generator=gen)
    perm = (key + 2.0 * (e.ids < 0)).argsort(dim=1)
    return ell.EllMatrix(e.vals.gather(1, perm), e.ids.gather(1, perm),
                         e.lens, e.shape, e.major_axis)


def check_product(label, out, a_d, b_d) -> float:
    """Shape, finiteness and relative error against a float64 product on
    the card; raises on a failure, returns the relative error."""
    if tuple(out.shape) != (a_d.shape[0], b_d.shape[1]) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{label}: bad output {tuple(out.shape)}")
    ref = a_d.double() @ b_d.double()
    rel = float((out.double() - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30))
    if rel > TOL["float32"]:
        raise AssertionError(f"{label}: relative error {rel:.3e} against "
                             "the float64 product")
    return rel


def counts():
    return {k: v for c in COUNTERS for k, v in c.items()}


def reset_counts():
    for c in COUNTERS:
        for key in c:
            c[key] = 0


def placement(a):
    return ", ".join(f"{pp.partition.cls.value}"
                     f"{' mirror' if pp.partition.mirror else ''}"
                     f" k[{pp.partition.region.k0}:{pp.partition.region.k1}]"
                     f" on {pp.partition.cluster}" for pp in a.placed)


def run_queue(label, run):
    """Run a many-kernel call, timing it on the host clock (ending in a
    synchronize), check every task against float64, and return its
    schedule and outputs."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, ms, pairs = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    rels = {}
    for asg in ms.assignments:
        a_d, b_d = pairs[asg.task_index]
        tag = f"{label} task {asg.task_index} {asg.workload.name}"
        rels[asg.task_index] = check_product(tag, outs[asg.task_index],
                                             a_d, b_d)
        log(f"many {tag} {asg.workload.m}x{asg.workload.k}x{asg.workload.n}"
            f": {placement(asg)}, rel err {rels[asg.task_index]:.3e}")
    log(f"many {label}: wall {wall_ms:.3f} ms for {len(pairs)} tasks, "
        f"modelled makespan {ms.makespan_cycles:.0f} cycles, worst rel err "
        f"{max(rels.values()):.3e}")
    return ms, outs


def measured_workload(name, a_d, b_d):
    """The workload ``hetero_many_matmul`` builds for ``(a_d, b_d)``: true
    shapes and exact densities."""
    (m, k), n = a_d.shape, b_d.shape[1]
    nnz = [int(torch.count_nonzero(x)) for x in (a_d, b_d)]
    return Workload(name, "api", m, k, n, nnz[0] / a_d.numel(),
                    nnz[1] / b_d.numel())


def serve_trace(config, workloads):
    """18 requests from 3 tenants: each workload twice, arrivals staggered
    at 0.25 × the mean per-task share of the offline ``lpt`` makespan, SLA =
    arrival + half that makespan (``examples/serve_cluster.py``'s
    ``build_trace``)."""
    ws = list(workloads) * 2
    base = scheduler.schedule_many_kernels(config, ws)
    gap = base.makespan_cycles / len(ws) * 0.25
    slack = base.makespan_cycles * 0.5
    return [cluster.Request(f"req{i:02d}", TENANTS[i % len(TENANTS)], w,
                            arrival_cycles=i * gap,
                            deadline_cycles=i * gap + slack, seed=i)
            for i, w in enumerate(ws)]


def measured_line(label, config, timelines, wall_ms, base, peak):
    """Log a streamed run's measured per-cluster busy, makespan and
    spatial speedup (``aggregate_timelines``) beside its wall and peak
    memory (and the memory allocated before the run); return the
    figures."""
    busy, makespan, sequential = aggregate_timelines(timelines,
                                                     len(config.clusters))
    spans = hm.cluster_submeshes(N_LANES, config)
    # Lane overlap: per batch, Σ span busy over the union window of the
    # spans that held work (device time), summed over the batches.
    windows = []
    for tl in timelines:
        live = [sp for sp in tl.spans if sp.busy_s > 0]
        if live:
            windows.append((max(sp.end_s for sp in live)
                            - min(sp.start_s for sp in live),
                            sum(sp.busy_s for sp in live)))
    window_s = sum(w for w, _ in windows)
    rec = {
        "wall_ms": wall_ms, "base_mb": base / 2 ** 20,
        "peak_mb": peak / 2 ** 20,
        "batches": len(timelines),
        "busy_ms": {f"{c.name} lanes {lo}-{hi - 1}": b * 1e3
                    for c, (_, lo, hi), b in zip(config.clusters, spans,
                                                 busy)},
        "measured_makespan_ms": makespan * 1e3,
        "measured_sequential_ms": sequential * 1e3,
        "measured_spatial_speedup": (sequential / makespan
                                     if makespan > 0 else 0.0),
        "lane_windows_ms": window_s * 1e3,
        "lane_overlap": (sum(b for _, b in windows) / window_s
                         if window_s > 0 else 0.0)}
    log(f"{label} measured: " + json.dumps(rec))
    log(f"{label} timelines: " + json.dumps([tl.to_json()
                                             for tl in timelines]))
    return rec


def streamed_queue(host_pairs, schedule, seq_outs):
    """Phase 3e: the queue on the stream executor from host operands; every
    output the same bits as the sequential ``seq_outs``. Returns the
    launches of the run."""
    n = len(host_pairs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hm.execute_many_kernel_schedule(host_pairs, schedule)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t1) * 1e3
    log(f"stream: sequential path from host operands, wall {seq_ms:.3f} ms "
        f"for {n} tasks")

    def run(sink=None):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = hm.execute_many_kernel_schedule(
            host_pairs, schedule, mesh=StreamMesh(N_LANES), pipeline_depth=2,
            measure=True, timeline_sink=sink)
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t1) * 1e3

    # A first run pins its host buffers and grows each lane's memory pool;
    # the measured run after it is the steady state.
    torch.cuda.empty_cache()
    log(f"stream: first run (cold), wall {run()[1]:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    sink = []
    outs, wall_ms = run(sink)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    names = {a.task_index: a.workload.name for a in schedule.assignments}
    differ = [names[i] for i in range(n)
              if not torch.equal(outs[i], seq_outs[i])]
    if differ:
        raise AssertionError(f"streamed queue: {differ} not the same bits "
                             "as the sequential path")
    log(f"stream: {n} outputs the same bits as phase 3c's sequential ones, "
        f"launches {launches}")
    measured_line("stream", schedule.config, sink, wall_ms, base, peak)
    del outs
    # Each cluster's share of batch 0 alone on the same lanes: its busy
    # beside its busy in the batch is what the lanes cost each other
    # (whole-card launch plans, copy engines, memory).
    first = schedule.assignments[:sink[0].n_jobs]
    alone = {}
    for sp in sink[0].spans:
        mine = [a for a in first if a.cluster == sp.cluster]
        if mine:
            one = []   # the second of two runs
            for _ in range(2):
                one = []
                hm.execute_assignment_batches(
                    [mine], dict(enumerate(host_pairs)), schedule.config,
                    mesh=StreamMesh(N_LANES), measure=True,
                    timeline_sink=one)
            alone[schedule.config.clusters[sp.cluster].name] = {
                "tasks": [a.workload.name for a in mine],
                "alone_ms": one[0].spans[sp.cluster].busy_s * 1e3,
                "in_batch_ms": sp.busy_s * 1e3}
    log("stream batch 0, each cluster alone: " + json.dumps(alone))
    log("profile stream queue: " + json.dumps(profile_run(run, top=8)))
    return launches


def serving(config, requests, operands, card_pairs, offline):
    """Phase 3f: serve ``requests`` on the stream executor; every response
    against float64 and bit-equal to the ``mesh=None`` serve, placements
    and telemetry equal to ``offline``. Returns the launches of the
    run."""
    def serve():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sr = cluster.ClusterServer(config, policy="optimized").run_trace(
            requests, operands=operands, mesh=StreamMesh(N_LANES),
            pipeline_depth=2, measure=True)
        torch.cuda.synchronize()
        return sr, (time.perf_counter() - t1) * 1e3

    torch.cuda.empty_cache()
    log(f"serve: first serve (cold), wall {serve()[1]:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    sr, wall_ms = serve()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    base = cluster.ClusterServer(config, policy="optimized").run_trace(
        requests, operands=operands)
    torch.cuda.synchronize()
    log(f"serve: the mesh=None serve of the same trace, wall "
        f"{(time.perf_counter() - t1) * 1e3:.3f} ms")
    worst = 0.0
    for res, ref_res in zip(sr.results, base.results):
        r = res.request
        a_d, b_d = card_pairs[r.request_id]
        tag = f"serve {r.request_id} {r.workload.name}"
        worst = max(worst, check_product(tag, res.output, a_d, b_d))
        if not torch.equal(res.output, ref_res.output):
            raise AssertionError(f"{tag}: not the same bits as the "
                                 "mesh=None serve")
    by_index = {a.task_index: a.placed for a in offline.assignments}
    st = sr.report.stats
    if ([by_index[a.task_index] for a in sr.schedule.assignments]
            != [a.placed for a in sr.schedule.assignments]
            or st.p99_wait_cycles != offline.stats.p99_wait_cycles
            or st.busy_fraction != offline.stats.busy_fraction):
        raise AssertionError("served placements or telemetry differ from "
                             "the offline schedule")
    log(f"serve: {len(sr.results)} responses within {worst:.3e} of "
        "float64, the same bits as the mesh=None serve; placements, p99 "
        f"wait {st.p99_wait_cycles:.0f} cycles and busy fractions "
        f"{[round(f, 4) for f in st.busy_fraction]} equal to the offline "
        f"schedule; {sr.report.n_batches} batches, SLA misses "
        f"{st.deadline_misses}/{st.deadline_total}, launches {launches}")
    rec = measured_line("serve", config, sr.timelines, wall_ms, base_mem,
                        peak)
    if abs(rec["measured_spatial_speedup"]
           - st.measured_spatial_speedup) > 1e-9:
        raise AssertionError("report.stats.measured_* disagree with the "
                             "timelines")
    del sr, base
    log("profile serve: " + json.dumps(profile_run(serve, top=8)))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}"
                           f", not from this checkout ({ROOT})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s, "
        f"{sorted(p.name for p in libs.values())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # Operands and schedules of the main paths, made once from seed 0.
    config = dse.aespa_equal4()
    runs, host = [], {}
    for label, wname, max_elems in MAIN_PATH:
        w0 = BY_NAME[wname]
        a, b, (m, k, n) = synthesize(w0, seed=0, max_elems=max_elems)
        w = Workload(w0.name, w0.application, m, k, n, w0.d_mk, w0.d_kn)
        host[label] = (a, b)
        runs.append((label, w, torch.from_numpy(a).cuda(),
                     torch.from_numpy(b).cuda(),
                     scheduler.schedule_single_kernel(config, w)))
    queue = runs[:N_QUEUE]
    queue_pairs = [(a_d, b_d) for _, _, a_d, b_d, _ in queue]
    queue_host = [host[label] for label, *_ in queue]
    queue_runs = [(policy, scheduler.schedule_many_kernels(
        config, [r[1] for r in queue], policy=policy))
        for policy in ("lpt", "sjf", "affinity")]
    dense = [r for r in queue if r[0] == "synthetic_dense"][0]
    twice = [(dense[2], dense[3])] * 2
    optimized = scheduler.schedule_many_kernels(
        config, [measured_workload(f"task{i}", *ab)
                 for i, ab in enumerate(twice)], policy="optimized")
    # The searched design (phase 3d) and its schedules on the same nine.
    t0 = time.perf_counter()
    opt = dse.aespa_opt()
    log(f"phase 3d search: aespa_opt in {time.perf_counter() - t0:.2f} s, "
        "clusters " + ", ".join(f"{c.name} {c.pes} PEs"
                                for c in opt.clusters))
    opt_runs = [(label, w, a_d, b_d, scheduler.schedule_single_kernel(opt, w))
                for label, w, a_d, b_d, _ in queue]
    opt_lpt = scheduler.schedule_many_kernels(opt, [r[1] for r in queue],
                                              policy="lpt")
    # With bibd_81_3 reduced, lpt puts gnmt on the inner product and six
    # tasks on the Gustavson cluster (at Table I's dims, gnmt goes there).
    on_gust = [a.workload.name for a in opt_lpt.assignments
               if a.cls == DataflowClass.SPGEMM_GUSTAVSON]
    log("opt lpt placement: " + ", ".join(
        f"{a.workload.name} on {a.cls.value}" for a in opt_lpt.assignments))
    if not on_gust:
        raise AssertionError("lpt on aespa_opt put no task on the "
                             "Gustavson cluster")
    # Phase 3f's trace and the offline schedule its serve must equal.
    serve_reqs = serve_trace(opt, [r[1] for r in queue])
    by_name = {r[1].name: i for i, r in enumerate(queue)}
    serve_ops = {r.request_id: queue_host[by_name[r.workload.name]]
                 for r in serve_reqs}
    serve_card = {r.request_id: queue_pairs[by_name[r.workload.name]]
                  for r in serve_reqs}
    serve_offline = scheduler.schedule_many_kernels(
        opt, [r.workload for r in serve_reqs], policy="optimized",
        arrivals=[r.arrival_cycles for r in serve_reqs])
    serve_pairs = [serve_card[r.request_id] for r in serve_reqs]
    log("serve optimized placement: " + ", ".join(
        f"{serve_reqs[a.task_index].request_id} {a.workload.name}: "
        f"{placement(a)}" for a in serve_offline.assignments))

    # ---- phase 2: each kernel against its plain version ----------------
    # Every launch shape of phases 3 and 3c, each once.
    t0 = time.perf_counter()
    rows, seen = [], set()
    launch_sets = [(label, a_d, b_d, schedule.partitions)
                   for label, w, a_d, b_d, schedule in runs]
    launch_sets += [(f"opt {label}", a_d, b_d, schedule.partitions)
                    for label, w, a_d, b_d, schedule in opt_runs]
    for policy, ms, pairs in ([(p, ms, queue_pairs) for p, ms in queue_runs]
                              + [("optimized", optimized, twice),
                                 ("opt lpt", opt_lpt, queue_pairs),
                                 ("serve", serve_offline, serve_pairs)]):
        launch_sets += [(f"{policy} {asg.workload.name}",
                         *pairs[asg.task_index],
                         [pp.partition for pp in asg.placed])
                        for asg in ms.assignments]
    redesigned = []
    for label, a_d, b_d, partitions in launch_sets:
        for case in partition_cases(label, a_d, b_d, partitions, seen):
            rows.append(case.check(reps=5))
            other = case.other[0] if case.other else None
            if {case.body, other} & KERNEL_NAMES.keys():
                redesigned.append((case, rows[-1]))
        torch.cuda.empty_cache()
    # The kernels alone, without their wrappers' pre-passes: each body,
    # chosen or passed over, at every launch shape.
    for case, row in redesigned:
        if case.body in KERNEL_NAMES:
            row["kernel_only_ms"] = kernel_only_ms(
                case.kernel, (KERNEL_NAMES[case.body],))
        name, call = case.other or (None, None)
        if name in KERNEL_NAMES:
            row["other_kernel_only_ms"] = kernel_only_ms(
                call, (KERNEL_NAMES[name],))
        log("alone " + json.dumps({k: row[k] for k in (
            "name", "case", "ms", "kernel_only_ms", "other_body",
            "other_ms", "other_kernel_only_ms", "library_ms",
            "bound_ms") if k in row}))
    del redesigned
    for case in edge_cases():
        case.check()
    scan_checks()
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: the single-kernel path --------------------------------
    t0 = time.perf_counter()
    reset_counts()
    for label, w, a_d, b_d, schedule in runs:
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = hm.execute_schedule(a_d, b_d, schedule)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        bodies = {k: v - before[k] for k, v in counts().items()
                  if v != before[k]}
        rel = check_product(label, out, a_d, b_d)
        parts = [region_tag("", p).strip() for p in schedule.partitions]
        log(f"main {label} {w.m}x{w.k}x{w.n}: partitions {parts}, bodies "
            f"{bodies}, wall {wall_ms:.3f} ms, rel err {rel:.3e}")
        del out
        torch.cuda.empty_cache()
    single_launches = counts()
    log(f"phase 3 single-kernel path: {time.perf_counter() - t0:.1f} s, "
        f"launches {single_launches}")

    # ---- phase 3b: where the single-kernel path's time goes -------------
    t0 = time.perf_counter()
    for label, w, a_d, b_d, schedule in runs:
        log(f"profile {label}: " + json.dumps(
            profile_run(lambda: hm.execute_schedule(a_d, b_d, schedule))))
    log(f"phase 3b profile: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3c: the many-kernel path ---------------------------------
    t0 = time.perf_counter()
    reset_counts()
    for policy, ms in queue_runs:
        run_queue(policy, lambda: (hm.execute_many_kernel_schedule(
            queue_pairs, ms), ms, queue_pairs))
    got, _ = run_queue("optimized synthetic_dense x2", lambda: (
        *hm.hetero_many_matmul(twice, config, policy="optimized"), twice))
    # Phase 3e holds the stream executor to these outputs, bit for bit.
    _, opt_lpt_outs = run_queue("opt lpt", lambda: (
        hm.execute_many_kernel_schedule(queue_pairs, opt_lpt), opt_lpt,
        queue_pairs))
    many_launches = counts()
    if [a.placed for a in got.assignments] != [
            a.placed for a in optimized.assignments]:
        raise AssertionError("hetero_many_matmul placed the queue otherwise "
                             "than the schedule phase 2 checked")
    log(f"phase 3c many-kernel path: {time.perf_counter() - t0:.1f} s, "
        f"launches {many_launches}")
    t0 = time.perf_counter()
    for policy, ms in queue_runs:
        log(f"profile {policy} queue: " + json.dumps(profile_run(
            lambda: hm.execute_many_kernel_schedule(queue_pairs, ms),
            top=8)))
    log("profile optimized synthetic_dense x2: " + json.dumps(profile_run(
        lambda: hm.hetero_many_matmul(twice, config, policy="optimized"),
        top=8)))
    log("profile opt lpt queue: " + json.dumps(profile_run(
        lambda: hm.execute_many_kernel_schedule(queue_pairs, opt_lpt),
        top=8)))
    log(f"phase 3c profile: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3d: the single-kernel path on aespa_opt -------------------
    t0 = time.perf_counter()
    reset_counts()
    for label, w, a_d, b_d, schedule in opt_runs:
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = hm.execute_schedule(a_d, b_d, schedule)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        bodies = {k: v - before[k] for k, v in counts().items()
                  if v != before[k]}
        rel = check_product(f"opt {label}", out, a_d, b_d)
        parts = [region_tag("", p).strip() for p in schedule.partitions]
        log(f"opt {label} {w.m}x{w.k}x{w.n}: partitions {parts}, bodies "
            f"{bodies}, wall {wall_ms:.3f} ms, rel err {rel:.3e}")
        del out
        torch.cuda.empty_cache()
    opt_launches = counts()
    log(f"phase 3d aespa_opt path: {time.perf_counter() - t0:.1f} s, "
        f"launches {opt_launches}")
    t0 = time.perf_counter()
    for label, w, a_d, b_d, schedule in opt_runs:
        log(f"profile opt {label}: " + json.dumps(
            profile_run(lambda: hm.execute_schedule(a_d, b_d, schedule))))
    log(f"phase 3d profile: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3e: the stream executor ----------------------------------
    t0 = time.perf_counter()
    stream_launches = streamed_queue(queue_host, opt_lpt, opt_lpt_outs)
    del opt_lpt_outs
    log(f"phase 3e stream executor: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3f: serving on the stream executor ------------------------
    t0 = time.perf_counter()
    serve_launches = serving(opt, serve_reqs, serve_ops, serve_card,
                             serve_offline)
    log(f"phase 3f serving: {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: the kernels line ---------------------------------------
    launches = {k: single_launches[k] + many_launches[k] + opt_launches[k]
                + stream_launches[k] + serve_launches[k] for k in REPLACES}
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            raise AssertionError(f"{name}: no main-path launch shape")
        top = max(mine, key=lambda r: r["ms"])  # the dominant launch
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "case": top["case"],
            **({"kernel_only_ms": top["kernel_only_ms"]}
               if "kernel_only_ms" in top else {})})
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
