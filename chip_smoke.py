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
   3g. The fleet: ``FleetServer(aespa_opt, n_replicas=3,
   policy="affinity", fault_plan=FaultPlan.kill_mid_batch(target, 0),
   failover_detect_cycles=1000.0).run_trace(..., mesh=StreamMesh(8),
   pipeline_depth=2)`` on phase 3f's trace and operands (``target`` is the
   replica the router gives ``req00``'s tenant; ``examples/fleet_serve.py``
   builds the same fleet). Every request served exactly once, at least one
   requeued, two replicas live; every output within ``1e-4`` relative of
   float64 and the same bits as the same fleet's ``mesh=None`` run; every
   surviving replica's schedule equal to the offline ``affinity``
   ``schedule_many_kernels`` on its admissions; every class the fleet
   placed work on launched. After a first (cold) run, the measured one's
   wall beside phase 3f's, peak memory, launches, requeued and SLA misses
   (failover and tenant), then one run under ``torch.profiler``; the
   ``backend="subprocess"`` fleet (three child interpreters, telemetry
   only) must route and time every request as the in-process one does.
   The fleet's Chrome trace goes to ``chiprun_out/fleet_trace.json``.
   3h. LM serving: olmoe-1b-7b (``repro_torch.configs``) at full width and
   depth in bfloat16, initialised on the card from seed 0, serves 4
   prompts of 128 tokens with 32 new tokens each through
   ``serve.engine.greedy_generate`` (``s_max=160``): init, prefill and
   decode-step ms (median after warm-up), generated tokens/s and peak
   memory beside the step's bound (every weight read once at 3.35 TB/s);
   every token in the vocabulary, and a second run gives the same tokens.
   Then olmoe at full width with 2 layers in float32 (``capacity_factor
   =16``): each decode step's logits within 5e-3 of ``forward``'s
   (``tests/test_serve.py``'s MoE tolerance), and ``greedy_generate``
   equal to ``greedy_generate_reference`` on 2 prompts of 32 tokens with
   8 new ones (a position whose top-2 logit gap lies within the tolerance
   is printed, not failed). Last, the MoE routing as the paper's SpMM:
   the first block's ``moe_mlp`` on the 512 prompt tokens gives the
   routing, ``routing_as_ell`` the (512 × 64) U_T C_E matrix at density
   8/64, and ``ops.spmm_mirror`` multiplies it on the card by a (64 ×
   2048) expert-summary matrix, "auto" (the sparse body) and
   "reference", each within ``1e-4`` relative of float64 and the same
   bits twice; ``schedule_single_kernel(aespa_equal4())`` places the
   dispatch workload. Phase 2 holds the SpMM kernel at this launch shape
   (a routing of the same shape from the seed).
   3i. LM serving of the other families, each at full width and depth in
   bfloat16, initialised on the card from seed 0, with the same numbers
   as phase 3h (init, prefill or encode, decode-step ms, tokens/s, peak
   memory, the step's bound, a profile of one decode step) and the same
   tokens twice: recurrentgemma-2b (RG-LRU and local attention) on 4
   prompts of 2048 tokens with 32 new each through ``greedy_generate``
   (``s_max=2080``: decoding runs past the 2048-token window), every token
   in the vocabulary; mamba2-370m (SSD) on 4 prompts of 512 tokens (two
   SSD chunks) with 32 new each; whisper-base (enc-dec) on frames (4,
   1500, 512) from seed 2: ``init_cache(4, 64, enc_len=1500)``,
   ``prefill_encdec_cache``, then 4-token prompts and 60 greedy tokens
   through ``make_decode_step``. Then the float32 checks at full width:
   recurrentgemma with 3 layers and a window of 16 (2 prompts of 32 + 8),
   mamba2 with 2 layers (2 prompts of 512 + 8), each decode step's logits
   within 5e-3 of ``forward``'s and ``greedy_generate`` equal to
   ``greedy_generate_reference`` (near ties printed, as in phase 3h);
   whisper at full depth on frames (2, 1500, 512), each decode step after
   ``prefill_encdec_cache`` within 3e-3 of ``forward(tokens, frames)``.
   The path launches none of the port's kernels.
   3j. LM training: qwen1.5-0.5b at full width and depth with bf16 params
   (``TrainConfig()``'s mixed precision, float32 master copies, xent chunk
   512, ``remat="block"``, warmup 2), initialised on the card from seed 0,
   on a synthetic ``TokenDataset`` (vocab 151936, 4 × 4096 tokens a step,
   seed 1234): 8 steps overfitting ``batch_at(0)`` (the loss falls, every
   metric finite) with init ms, step ms (host clock ending in a
   synchronize, median of steps 3-8 and its range), tokens/s and peak
   memory beside the step's bound, and one step under ``torch.profiler``;
   then, at 2 layers deep (full width; ``TRAIN_DRIVER_LAYERS``: the full
   depth's 6.5 GB npz checkpoints cost 30-48 s a run), ``TrainDriver`` for
   8 steps, a checkpoint every 2 into a fresh
   temporary directory, with a failure injected at step 5 (one restart,
   the last checkpoint step 8), and again without it from the same initial
   state: the same final loss (within 1e-6 relative, the JAX test's bound,
   bits printed), and the last checkpoint restores the run's final state
   bit for bit, bf16 leaves included. Then a float32 check at full width
   with 2 layers: one step's grads through flash's ``autograd.Function``
   under ``remat="block"`` against plain autograd through the chunk loop
   under ``remat="none"``, each leaf within 1e-4 of its largest magnitude;
   flash alone at one layer's shape (q (4, 4096, 16, 1, 64) bf16, chunk
   1024): forward and backward ms, the bytes it keeps for backward (those
   of q, k, v, out and lse, nothing else), and
   ``scaled_dot_product_attention``'s forward + backward ms as a yardstick
   (never on the path); last ``repro_torch.launch.train.main`` on the
   reduced preset for 8 steps (its mesh path on a 1x1 mesh). The path
   launches none of the port's kernels.
   3k. Sharding: (a) phase 3j's training (the same config, seed and batch)
   through ``launch.train``'s mesh path on a ``DeviceMesh`` of one device
   (NCCL, a world of 1): the state sharded by ``param_pspecs`` (every
   placement ``Replicate``), ``grad_pspecs`` set; under ``remat="block"``
   and ``"block_save"`` the first losses equal phase 3j's (bits printed);
   for ``block_save`` step ms (median and range), peak memory, a profile
   and the op analysis (``launch.op_analysis``) of one step on the card:
   FLOPs by dtype, bytes, collectives, roofline terms and ``dominant``.
   (b) gemma3-1b at full width and depth, a bf16 ``init_cache(1, 524288)``
   (13.96 GB) filled before the position from a seed, 4 decode steps near
   the end of the cache context-parallel (``cache_pspecs(seq_shard=True)``,
   ``Axes(seq="data")``: the local scores and the max and sum all-reduces)
   against plain ``decode_step``: with bf16 params timed against the
   step's bound (cache and weights read once) with peak memory, the
   logits within bf16's 2e-2 normwise; with float32 params within 2e-3
   (``tests/test_sharded.py``'s bound). (c) ``python -m
   repro_torch.launch.dryrun`` as subprocesses (started first, on the
   host's cores): whisper-base x decode_32k on the 512-rank multipod mesh
   and qwen1.5-0.5b x train_4k on the 256-rank pod, each ``ok`` with its
   devices; their FLOPs, bytes, collectives by kind, ``dominant`` and
   wall printed, the records under ``chiprun_out/dryrun``. The phase
   launches none of the port's kernels.
4. A ``{"kernels": [...]}`` line with every kernel's launches on the main
   paths of phases 3, 3c, 3d, 3e, 3f, 3g, 3h, 3i, 3j and 3k (each must be
   > 0; the counts are set to 0 before each phase and read after it) and
   the numbers of phase 2, whose launch shapes include the serving, fleet
   and MoE routing ones.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
from repro_torch.checkpoint import latest_step, restore  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, TokenDataset  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.fleet import FaultPlan, FleetServer  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import flash as lm_flash  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import DriverConfig, TrainDriver  # noqa: E402
from repro_torch.serve import cluster  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainConfig,
    init_train_state,
    make_loss_fn,
    make_train_step,
)

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the f32
#: rate of the CUDA cores, the units the ported kernels compute on.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: The dense bf16 rate of the tensor cores (the LM's bf16 matmuls).
BF16_FLOPS_PER_S = 989e12

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
#: Phase 3g: three replicas, as ``examples/fleet_serve.py`` launches them.
FLEET_REPLICAS = ("replica0", "replica1", "replica2")
#: Phase 3h: the LM served at full width, its requests and the float32
#: check (2 layers, 2 prompts of 32 tokens, 8 new ones) at
#: tests/test_serve.py's MoE tolerance.
LM_ARCH = "olmoe-1b-7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 128, 32
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_NEW = 2, 2, 32, 8
LM_TOL = 5e-3
#: Phase 3i: the SSD and RG-LRU archs served at full width and depth,
#: (batch, prompt tokens, new tokens), and their float32 checks at full
#: width: (overrides, batch, prompt tokens, new tokens) at
#: tests/test_serve.py's SSD and RG-LRU tolerance. recurrentgemma's 2048
#: prompt tokens fill its local layers' window, so decoding runs past it;
#: its check keeps one (rec, rec, local) period with a window of 16, which
#: binds. mamba2's 512 are two SSD chunks of 256; its check's forward over
#: 520 tokens takes the gcd chunking (65 chunks of 8).
FAMILY_ARCHS = {"recurrentgemma-2b": (4, 2048, 32), "mamba2-370m": (4, 512, 32)}
FAMILY_CHECKS = {
    "recurrentgemma-2b": ({"n_layers": 3, "sliding_window": 16}, 2, 32, 8),
    "mamba2-370m": ({"n_layers": 2}, 2, 512, 8),
}
#: Phase 3i's enc-dec arch: (batch, encoder frames, prompt tokens, new
#: tokens). 1500 frames are Whisper's 30-s encoder context; its float32
#: check (full depth) decodes 2 rows of 40 tokens over 1500 frames against
#: forward at tests/test_serve.py's enc-dec tolerance.
ENCDEC_ARCH = "whisper-base"
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1500, 4, 60
ENCDEC_CHECK_BATCH, ENCDEC_CHECK_TOKENS, ENCDEC_TOL = 2, 40, 3e-3
#: Phase 3j: training at full width and depth (qwen1.5-0.5b, both JAX
#: trainers' default arch) on train_4k's sequence length with its batch of
#: 256 cut to 4 for one card; the synthetic data's seed is DataConfig's
#: default. The float32 grad check: full width, 2 layers, (batch, seq) at
#: two flash chunks, each leaf within 1e-4 of its largest magnitude. Flash
#: alone at one layer's shape: q (B, S, KV, G, dh), JAX's chunk.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_DATA_SEED = 4, 4096, 8, 1234
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 5, 2
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 2048
TRAIN_GRAD_TOL = 1e-4
FLASH_SHAPE, FLASH_CHUNK = (4, 4096, 16, 1, 64), 1024
#: Phase 3j's driver runs (two runs of 8 steps, a checkpoint every 2) at
#: full width and this depth: the npz checkpoints of the full depth (6.5 GB
#: each) took 30-48 s a run; at 2 layers the tied table dominates.
TRAIN_DRIVER_LAYERS = 2
#: Phase 3k: phase 3j's training through the mesh path on a mesh of one
#: device (the first steps' losses against phase 3j's, relative: a tolerance
#: only if the bits differ); context-parallel decode of gemma3-1b, the arch
#: of JAX's context-parallel test, at long_500k's cache (1 x 524288), its
#: logits within tests/test_sharded.py's 2e-3 of plain decode; two
#: dry-run cells (arch, shape, mesh, devices): JAX's one-cell test and the
#: training arch's train cell.
MESH_BLOCK_STEPS, MESH_SAVE_STEPS, MESH_LOSS_RTOL = 2, 5, 1e-6
CP_ARCH, CP_S_MAX, CP_STEPS, CP_TOL = "gemma3-1b", 524288, 4, 2e-3
DRYRUN_CELLS = (("whisper-base", "decode_32k", "multipod", 512),
                ("qwen1.5-0.5b", "train_4k", "singlepod", 256))
DRYRUN_TIMEOUT_S = 300
#: The device phases 3h-3k run on (a CPU rehearsal sets it to "cpu").
LM_DEVICE = "cuda"
#: The kernel bodies that run each dataflow class's partitions.
BODIES = {
    DataflowClass.GEMM: ("gemm",),
    DataflowClass.SPMM: ("spmm_sparse", "spmm_reference"),
    DataflowClass.SPGEMM_INNER: ("inner_sparse", "inner_reference"),
    DataflowClass.SPGEMM_OUTER: ("outer_sparse", "outer_reference"),
    DataflowClass.SPGEMM_GUSTAVSON: ("gustavson_sparse",
                                     "gustavson_reference"),
}

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
    return launches, wall_ms


def fleet_target(requests) -> int:
    """The replica the fleet's router gives the first request's tenant."""
    rid = Router(list(FLEET_REPLICAS)).route(requests[0].tenant)
    return FLEET_REPLICAS.index(rid)


def fleet_server(config, target=None, backend="inproc"):
    """Phase 3g's fleet: three replicas under ``affinity``; replica
    ``target`` killed mid-way through its first batch (no fault when
    ``target`` is None, as the subprocess backend needs)."""
    if target is None:
        return FleetServer(config, n_replicas=len(FLEET_REPLICAS),
                           policy="affinity", backend=backend)
    return FleetServer(config, n_replicas=len(FLEET_REPLICAS),
                       policy="affinity",
                       fault_plan=FaultPlan.kill_mid_batch(target, batch=0),
                       failover_detect_cycles=1000.0)


def fleet_assignments(fr):
    """``(replica outcome, request_id, assignment)`` for every placement a
    fleet run executes: survivors' final schedules, the dead replica's
    retired work."""
    out = []
    for ro in fr.replicas:
        rid_of = {i: rid for i, rid, _ in ro.admitted}
        done = (ro.schedule.assignments if ro.schedule is not None
                else ro.retired)
        out += [(ro, rid_of[a.task_index], a) for a in done]
    return out


def fleet(config, requests, operands, card_pairs, serve_wall_ms):
    """Phase 3g: the fleet with a replica killed mid-batch on the stream
    executor; every response once, against float64, bit-equal to the
    ``mesh=None`` fleet, survivors' schedules equal to the offline oracle,
    the subprocess backend's routing equal to the in-process one's.
    Returns the launches of the run."""
    target = fleet_target(requests)

    def run(mesh=True):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fr = fleet_server(config, target).run_trace(
            requests, operands=operands,
            mesh=StreamMesh(N_LANES) if mesh else None,
            pipeline_depth=2 if mesh else 1)
        torch.cuda.synchronize()
        return fr, (time.perf_counter() - t1) * 1e3

    torch.cuda.empty_cache()
    log(f"fleet: first run (cold), wall {run()[1]:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    fr, wall_ms = run()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    base, base_ms = run(mesh=False)

    ids = [rec.request.request_id for rec in fr.records]
    if (sorted(ids) != sorted(r.request_id for r in requests)
            or len(set(ids)) != len(ids)):
        raise AssertionError(f"fleet: requests not served exactly once: "
                             f"{ids}")
    rep = fr.report
    if rep.requeued_requests < 1 or rep.n_replicas_live != 2:
        raise AssertionError(
            f"fleet: requeued {rep.requeued_requests}, live replicas "
            f"{rep.n_replicas_live}; the kill of replica{target} should "
            "requeue work and leave two")
    worst = 0.0
    for rec, ref_rec in zip(fr.records, base.records):
        r = rec.request
        tag = f"fleet {r.request_id} {r.workload.name} on {rec.replica}"
        worst = max(worst, check_product(tag, rec.output,
                                         *card_pairs[r.request_id]))
        if (ref_rec.request.request_id != r.request_id
                or not torch.equal(rec.output, ref_rec.output)):
            raise AssertionError(f"{tag}: not the same bits as the "
                                 "mesh=None fleet")
    by_id = {r.request_id: r for r in requests}
    for ro in fr.replicas:
        if not ro.alive or not ro.admitted:
            continue
        off = scheduler.schedule_many_kernels(
            config, [by_id[rid].workload for _, rid, _ in ro.admitted],
            policy="affinity", arrivals=[adm for _, _, adm in ro.admitted])
        placed = {a.task_index: a.placed for a in off.assignments}
        if (ro.schedule.makespan_cycles != off.makespan_cycles
                or any(a.placed != placed[a.task_index]
                       for a in ro.schedule.assignments)):
            raise AssertionError(f"fleet: {ro.rid}'s schedule differs from "
                                 "the offline affinity schedule")
    classes = {pp.partition.cls for _, _, a in fleet_assignments(fr)
               for pp in a.placed if not pp.partition.region.empty}
    idle = [c.value for c in classes
            if not any(launches[k] for k in BODIES[c])]
    if idle:
        raise AssertionError(f"fleet: no kernel launched for {idle}")
    log(f"fleet: {len(ids)} requests served once on {rep.n_replicas_live} "
        f"of {rep.n_replicas_launched} replicas (replica{target} killed at "
        f"{fr.replicas[target].death_cycles:.0f} cycles), requeued "
        f"{rep.requeued_requests}, within {worst:.3e} of float64, the same "
        "bits as the mesh=None fleet; surviving schedules equal to the "
        f"offline affinity schedule; {rep.n_batches} batches, SLA misses "
        f"{rep.sla_misses_total}/{rep.stats.deadline_total} (failover "
        f"{rep.sla_misses_failover}, tenant {rep.sla_misses_tenant}); "
        f"launches {launches}")
    log("fleet replicas: " + json.dumps([
        {k: r[k] for k in ("rid", "alive", "death_cycles", "n_requests",
                           "n_batches", "makespan_cycles")}
        for r in (pr.to_json() for pr in rep.per_replica)]))
    log("fleet measured: " + json.dumps({
        "wall_ms": wall_ms, "serve_wall_ms": serve_wall_ms,
        "mesh_none_wall_ms": base_ms, "base_mb": base_mem / 2 ** 20,
        "peak_mb": peak / 2 ** 20}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    fr.export_chrome_trace(out / "fleet_trace.json")
    del fr, base

    # The subprocess backend: three child interpreters (telemetry only)
    # against the in-process fleet with the same (fault-free) ring.
    t1 = time.perf_counter()
    fs = fleet_server(config, backend="subprocess").run_trace(
        requests, execute=False)
    sub_ms = (time.perf_counter() - t1) * 1e3
    fi = fleet_server(config, backend="inproc").run_trace(requests,
                                                          execute=False)
    admitted = fs.aggregate_metrics()["counters"].get("serve.admitted")
    if ([(r.replica, r.start_cycles, r.finish_cycles) for r in fs.records]
            != [(r.replica, r.start_cycles, r.finish_cycles)
                for r in fi.records] or admitted != len(requests)):
        raise AssertionError("fleet: the subprocess backend routed or timed "
                             "requests otherwise than the in-process one")
    log(f"fleet: subprocess backend, {len(fs.records)} requests routed and "
        f"timed as in process, children's serve.admitted {admitted:.0f}, "
        f"wall {sub_ms:.1f} ms")
    log("profile fleet: " + json.dumps(profile_run(run, top=8)))
    return launches


def synthetic_routing(t, e, k, gen):
    """A top-``k`` routing of ``t`` tokens over ``e`` experts from random
    router logits: (weights (t, k) float32, experts (t, k) int32), the
    shape the MoE layer gives."""
    logits = torch.randn((t, e), generator=gen, device=gen.device)
    w, idx = torch.topk(logits, k, dim=-1, sorted=True)
    return torch.softmax(w, dim=-1), idx.to(torch.int32)


def routing_case(label, weights, idx, summaries):
    """The SpMM launch of ``ops.spmm_mirror(routing_as_ell(weights, idx,
    E), summaries)`` as a kernel case."""
    r = lm_moe.routing_as_ell(weights, idx, summaries.shape[0])
    return spmm_case(label, *ops.spmm_mirror_operands(r, summaries))


def tree_bytes(tree) -> int:
    leaves = []
    tree_map(leaves.append, tree)
    return nbytes(*leaves)


def prefill_flops(cfg, b, s) -> float:
    """Operations of one prefill as the model runs it: the projections,
    every (query, key) pair of the one-chunk attention, the expert FFNs
    over every capacity slot, the router, and the last position's
    logits."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cap = max(8, int(s * cfg.experts_per_token * cfg.capacity_factor
                     / cfg.n_experts))
    proj = 2.0 * b * s * d * (2 * h * dh + 2 * kv * dh)
    attn = 4.0 * b * s * s * h * dh
    ffn = 2.0 * b * cfg.n_experts * cap * 3 * d * cfg.d_ff
    router = 2.0 * b * s * d * cfg.n_experts
    return (cfg.n_layers * (proj + attn + ffn + router)
            + 2.0 * b * d * lm.padded_vocab(cfg))


def block_flops(tree, tokens: int) -> float:
    """2 operations per weight per token over every block of ``tree``
    (attention scores and the scans not counted)."""
    leaves = []
    tree_map(leaves.append, {k: tree[k] for k in ("blocks", "tail")})
    return 2.0 * tokens * sum(t.numel() for t in leaves)


def family_prefill_flops(cfg, b, s):
    """Operations of one phase 3i prefill: 2 per block weight per token,
    every (query, key) pair of each attention layer (the flash chunks run
    whole, masked or not), and the last position's logits; the SSD and
    RG-LRU scans not counted. Returns a function of the params."""
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
    attn = 4.0 * n_attn * b * s * s * cfg.n_heads * cfg.d_head
    logits = 2.0 * b * cfg.d_model * lm.padded_vocab(cfg)
    return lambda params: block_flops(params, b * s) + attn + logits


def steps_ms(step, params, cache, tokens, start, n):
    """Host ms of decode steps ``start`` .. ``start + n - 1``, fed the
    tokens the run chose (``tokens[:, i]`` at position ``i``), each ending
    in a synchronize; then one more step under the profiler. Returns (the
    step times, the profile)."""
    b, dev = tokens.shape[0], tokens.device
    times = []
    with torch.inference_mode():
        for i in range(start, start + n):
            pos = torch.full((b,), i, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, cache = step(params, cache, tokens[:, i:i + 1], pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        pos = torch.full((b,), start, dtype=torch.int32, device=dev)
        profile = profile_run(
            lambda: step(params, cache, tokens[:, start:start + 1], pos),
            top=8)
    return times, profile


def init_on_card(model):
    """Params from seed 0 on the card: (params, init ms, base bytes)."""
    dev = torch.device(LM_DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    return params, (time.perf_counter() - t1) * 1e3, base_mem


def check_generated(tag, cfg, first, again, prompt, total):
    """Both runs the same tokens, extending the prompt, every one in the
    vocabulary."""
    b, s = prompt.shape
    if tuple(first.shape) != (b, total) or not torch.equal(
            first[:, :s], prompt):
        raise AssertionError(f"{tag}: output {tuple(first.shape)} does not "
                             "extend the prompt")
    if int(first.min()) < 0 or int(first.max()) >= cfg.vocab_size:
        raise AssertionError(f"{tag}: a token outside the vocabulary")
    if not torch.equal(first, again):
        raise AssertionError(f"{tag}: two runs from the same seed gave "
                             "different tokens")


def serve_full_width(cfg, batch, prompt_len, new, flops):
    """Phase 3h part 1 and phase 3i: ``cfg`` at full width on the card;
    greedy generation of ``new`` tokens after ``batch`` prompts of
    ``prompt_len``, twice from the seed (the same tokens), with its init,
    prefill and decode-step times, tokens/s and peak memory beside the
    step's bound (every weight read once). ``flops(params)``: the
    prefill's operations. Returns the params and the prompt."""
    model = build(cfg)
    dev = torch.device(LM_DEVICE)
    params, init_ms, base_mem = init_on_card(model)
    weight_bytes = tree_bytes(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    s_max = prompt_len + new

    def generate():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = engine.greedy_generate(model, params, prompt, n_steps=new,
                                     s_max=s_max, device=dev)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    first, cold_ms = generate()
    again, wall_ms = generate()
    check_generated(f"lm {cfg.name}", cfg, first, again, prompt, s_max)

    # The prefill and the decode steps alone, on the same prompt and the
    # tokens the run chose.
    prefill = engine.make_prefill(model, with_cache=True)
    with torch.inference_mode():
        cache0 = model.init_cache(batch, s_max, device=dev)
        prefill_ms = time_ms(lambda: prefill(params, cache0, prompt), 5)
        _, cache = prefill(params, cache0, prompt)
        del cache0
    step_ms, step_profile = steps_ms(engine.make_decode_step(model), params,
                                     cache, first, prompt_len, new - 1)
    del cache
    peak = torch.cuda.max_memory_allocated()
    bound_step_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    flops = flops(params)
    log(f"lm: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}, {weight_bytes / 1e9:.3f} GB of weights; {batch} "
        f"prompts of {prompt_len} tokens, {new} new each: the same tokens "
        "twice, every one in the vocabulary")
    log("lm measured: " + json.dumps({
        "arch": cfg.name, "init_ms": init_ms, "generate_cold_ms": cold_ms,
        "generate_ms": wall_ms, "prefill_ms": prefill_ms,
        "decode_step_ms": statistics.median(step_ms[2:]),
        "decode_step_ms_all": step_ms,
        "tokens_per_s": batch * new / (wall_ms / 1e3),
        "base_mb": base_mem / 2 ** 20,
        "peak_mb_above_base": (peak - base_mem) / 2 ** 20,
        "weight_bytes": weight_bytes, "step_bound_ms": bound_step_ms,
        "prefill_flops": flops,
        "prefill_bound_ms": max(bound_step_ms,
                                flops / BF16_FLOPS_PER_S * 1e3)}))
    log(f"profile lm {cfg.name} decode step: " + json.dumps(step_profile))
    return params, prompt


def near_tie(model, params, row, j, tol):
    """The top-2 logit gap of ``forward`` at the last of ``row[:j]``, if
    it lies within ``tol`` (a tie greedy decoding may break either way);
    else raise."""
    with torch.inference_mode():
        lg, _ = model.forward(params, {"tokens": row[None, :j]})
    top = torch.topk(lg[0, -1, :model.cfg.vocab_size], 2).values
    gap = float(top[0] - top[1])
    if gap > tol * (1.0 + float(top[0].abs())):
        raise AssertionError(f"lm f32 {model.cfg.name}: greedy_generate "
                             f"differs from the reference at position {j}, "
                             f"top-2 gap {gap:.3e}")
    return gap


def check_decode(tag, step, params, cache, toks, want, tol) -> float:
    """Each decode step's logits against ``want`` (``forward``'s) by
    assert_allclose's rule at rtol = atol = ``tol``; returns the worst."""
    b, worst = toks.shape[0], 0.0
    with torch.inference_mode():
        for i in range(toks.shape[1]):
            pos = torch.full((b,), i, dtype=torch.int32, device=toks.device)
            got, cache = step(params, cache, toks[:, i:i + 1], pos)
            w = want[:, i:i + 1]
            err = float(((got - w).abs() / (1.0 + w.abs())).max())
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"{tag}: decode step {i}'s logits "
                                     f"{err:.3e} from forward's")
    return worst


def check_full_width_f32(cfg, overrides, batch, prompt_len, new, tol):
    """Phase 3h part 2 and phase 3i: ``cfg`` at full width in float32 with
    ``overrides`` (its depth cut) and room for every token: decode-step
    logits against ``forward``'s, and ``greedy_generate`` against
    ``greedy_generate_reference``."""
    cfg = dataclasses.replace(cfg, dtype="float32", **overrides)
    model = build(cfg)
    dev = torch.device(LM_DEVICE)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    s = prompt_len + new
    toks = torch.randint(0, cfg.vocab_size, (batch, s), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        want, _ = model.forward(params, {"tokens": toks})
        worst = check_decode(f"lm f32 {cfg.name}",
                             engine.make_decode_step(model), params,
                             model.init_cache(batch, s, device=dev), toks,
                             want, tol)
        del want
    prompt = toks[:, :prompt_len]
    new_toks = engine.greedy_generate(model, params, prompt, new, s,
                                      device=dev)
    old = engine.greedy_generate_reference(model, params, prompt, new, s,
                                           device=dev)
    ties = []
    for r in range(batch):
        diff = (new_toks[r] != old[r]).nonzero()
        if len(diff):
            # The rows part at position j: the prefix before it is the same.
            j = int(diff[0])
            ties.append((r, j, near_tie(model, params, old[r], j, tol)))
    log(f"lm f32: {cfg.name} at full width, {cfg.n_layers} layers "
        f"{overrides}: {s} decode steps' logits within {worst:.3e} of "
        f"forward's (tol {tol}); greedy_generate equal to "
        f"greedy_generate_reference on {batch} prompts of {prompt_len} + "
        f"{new}" + (f", but for near ties (row, position, top-2 gap) {ties}"
                    if ties else ""))


def routing_spmm(cfg, params, prompt):
    """Phase 3h part 3: the first block's MoE routing of the prompt as the
    paper's U_T C_E matrix through the port's SpMM on the card, both
    bodies, against float64. Returns the launches of the two calls."""
    dev = torch.device(LM_DEVICE)
    blk = lm._index(params["blocks"]["s0"], 0)
    with torch.inference_mode():
        x = lm_layers.embed(params["embed"], prompt, cfg)
        positions = torch.arange(prompt.shape[1], device=dev)[None, :]
        h = lm_layers.rmsnorm(x, blk["norm1"], cfg.norm_eps)
        x = x + lm_layers.attention(blk["attn"], h, cfg, positions=positions)
        h2 = lm_layers.rmsnorm(x, blk["norm2"], cfg.norm_eps)
        _, (weights, idx) = lm_moe.moe_mlp(blk["ffn"], h2, cfg)
    t, e = weights.shape[0], cfg.n_experts
    r = lm_moe.routing_as_ell(weights, idx, e)
    gen = torch.Generator(device=dev).manual_seed(3)
    summaries = torch.randn((e, cfg.d_model), generator=gen, device=dev)
    reset_counts()
    outs = {m: ops.spmm_mirror(r, summaries, method=m)
            for m in ("auto", "reference")}
    launches = counts()
    want = ell.ell_to_dense(r).double() @ summaries.double()
    scale = float(want.abs().max())
    rels = {}
    for m, out in outs.items():
        if tuple(out.shape) != (t, cfg.d_model) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"lm routing {m}: bad output "
                                 f"{tuple(out.shape)}")
        rels[m] = float((out.double() - want).abs().max()) / scale
        if rels[m] > TOL["float32"]:
            raise AssertionError(f"lm routing {m}: {rels[m]:.3e} from "
                                 "float64")
        if not torch.equal(out, ops.spmm_mirror(r, summaries, method=m)):
            raise AssertionError(f"lm routing {m}: two runs differ")
    density = float(r.density())
    w = Workload("moe_dispatch", "LM", t, e, cfg.d_model, density, 1.0)
    sched = scheduler.schedule_single_kernel(dse.aespa_equal4(), w)
    classes = sorted({p.cls.value for p in sched.partitions})
    log(f"lm routing: ({t} x {e}) U_T C_E matrix, density {density:.4f}, "
        f"cap {r.cap}; spmm_mirror by a ({e} x {cfg.d_model}) matrix on the "
        f"card, rel err auto {rels['auto']:.3e}, reference "
        f"{rels['reference']:.3e}, the same bits twice; launches "
        f"{launches}; aespa_equal4 places the dispatch on {classes}, "
        f"modelled {sched.report.runtime_s * 1e9:.0f} ns")
    return launches


def encdec_generate(model, params, frames, prompt, new, s_max):
    """The enc-dec serving path (``tests/test_serve.py:27-39``): the
    encoder fills the cross caches (``prefill_encdec_cache``), the prompt
    goes through ``make_decode_step`` token by token, then ``new`` greedy
    tokens. Returns (tokens (B, prompt + new), wall ms)."""
    b, s = prompt.shape
    step = engine.make_decode_step(model)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        cache = model.init_cache(b, s_max, enc_len=frames.shape[1],
                                 device=prompt.device)
        cache = engine.prefill_encdec_cache(model, params, frames, cache)
        tok, out = prompt[:, :1], [prompt[:, :1]]
        for i in range(s + new - 1):
            pos = torch.full((b,), i, dtype=torch.int32, device=prompt.device)
            logits, cache = step(params, cache, tok, pos)
            if i + 1 < s:
                tok = prompt[:, i + 1:i + 2]
            else:
                tok = torch.argmax(logits[:, -1, :model.cfg.vocab_size],
                                   dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        out = torch.cat(out, dim=1)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t1) * 1e3


def serve_encdec(cfg):
    """Phase 3i, enc-dec: ``cfg`` at full width and depth on the card;
    ``encdec_generate`` twice from the seed (the same tokens), with init,
    encode (``prefill_encdec_cache``) and decode-step times, tokens/s and
    peak memory beside the step's bound."""
    model = build(cfg)
    dev = torch.device(LM_DEVICE)
    params, init_ms, base_mem = init_on_card(model)
    weight_bytes = tree_bytes(params)
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model),
                         generator=gen, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    s_max = ENCDEC_PROMPT + ENCDEC_NEW
    first, cold_ms = encdec_generate(model, params, frames, prompt,
                                     ENCDEC_NEW, s_max)
    again, wall_ms = encdec_generate(model, params, frames, prompt,
                                     ENCDEC_NEW, s_max)
    check_generated(f"lm {cfg.name}", cfg, first, again, prompt, s_max)
    with torch.inference_mode():
        cache = model.init_cache(ENCDEC_BATCH, s_max, enc_len=ENCDEC_FRAMES,
                                 device=dev)
        encode_ms = time_ms(lambda: engine.prefill_encdec_cache(
            model, params, frames, cache), 3)
        cache = engine.prefill_encdec_cache(model, params, frames, cache)
        cross_bytes = sum(nbytes(c["ck"], c["cv"])
                          for c in [*cache["blocks"].values(),
                                    *cache["tail"]])
    step_ms, step_profile = steps_ms(engine.make_decode_step(model), params,
                                     cache, first, 0, s_max - 1)
    del cache
    peak = torch.cuda.max_memory_allocated()
    bound_step_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    enc_tokens = ENCDEC_BATCH * ENCDEC_FRAMES
    encode_flops = (block_flops(params["encoder"], enc_tokens)
                    + 4.0 * cfg.n_enc_layers * ENCDEC_BATCH
                    * ENCDEC_FRAMES ** 2 * cfg.n_heads * cfg.d_head
                    + 2.0 * cfg.n_layers * enc_tokens * cfg.d_model
                    * 2 * cfg.n_kv_heads * cfg.d_head)
    log(f"lm: {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype}, {weight_bytes / 1e9:.3f} GB "
        f"of weights, {cross_bytes / 1e9:.3f} GB of cross caches; "
        f"{ENCDEC_BATCH} rows of {ENCDEC_FRAMES} frames, prompts of "
        f"{ENCDEC_PROMPT} tokens, {ENCDEC_NEW} new each: the same tokens "
        "twice, every one in the vocabulary")
    log("lm measured: " + json.dumps({
        "arch": cfg.name, "init_ms": init_ms, "generate_cold_ms": cold_ms,
        "generate_ms": wall_ms, "encode_ms": encode_ms,
        "decode_step_ms": statistics.median(step_ms[2:]),
        "decode_step_ms_all": step_ms,
        "tokens_per_s": ENCDEC_BATCH * ENCDEC_NEW / (wall_ms / 1e3),
        "base_mb": base_mem / 2 ** 20,
        "peak_mb_above_base": (peak - base_mem) / 2 ** 20,
        "weight_bytes": weight_bytes, "cross_cache_bytes": cross_bytes,
        "step_bound_ms": bound_step_ms, "encode_flops": encode_flops,
        "encode_bound_ms": max(bound_step_ms,
                               encode_flops / BF16_FLOPS_PER_S * 1e3)}))
    log(f"profile lm {cfg.name} decode step: " + json.dumps(step_profile))


def check_encdec_f32(cfg):
    """Phase 3i, enc-dec: ``cfg`` at full width and depth in float32; each
    decode step after ``prefill_encdec_cache`` against ``forward(tokens,
    frames)``."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build(cfg)
    dev = torch.device(LM_DEVICE)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn((ENCDEC_CHECK_BATCH, ENCDEC_FRAMES, cfg.d_model),
                         generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size,
                         (ENCDEC_CHECK_BATCH, ENCDEC_CHECK_TOKENS),
                         generator=gen, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        want, _ = model.forward(params, {"tokens": toks, "frames": frames})
        cache = engine.prefill_encdec_cache(
            model, params, frames,
            model.init_cache(ENCDEC_CHECK_BATCH, ENCDEC_CHECK_TOKENS,
                             enc_len=ENCDEC_FRAMES, device=dev))
        worst = check_decode(f"lm f32 {cfg.name}",
                             engine.make_decode_step(model), params, cache,
                             toks, want, ENCDEC_TOL)
    log(f"lm f32: {cfg.name} at full width and depth: "
        f"{ENCDEC_CHECK_TOKENS} decode steps after prefill_encdec_cache "
        f"over {ENCDEC_FRAMES} frames within {worst:.3e} of forward's (tol "
        f"{ENCDEC_TOL}) on {ENCDEC_CHECK_BATCH} rows")


def lm_families():
    """Phase 3i: the SSD, RG-LRU and enc-dec archs served at full width
    and depth, and their float32 checks. Returns the kernels' launches
    (the path runs none of the nine)."""
    reset_counts()
    for arch, (batch, prompt_len, new) in FAMILY_ARCHS.items():
        cfg = get_config(arch)
        params, _ = serve_full_width(
            cfg, batch, prompt_len, new,
            family_prefill_flops(cfg, batch, prompt_len))
        del params
        torch.cuda.empty_cache()
        check_full_width_f32(cfg, *FAMILY_CHECKS[arch], LM_TOL)
        torch.cuda.empty_cache()
    cfg = get_config(ENCDEC_ARCH)
    serve_encdec(cfg)
    torch.cuda.empty_cache()
    check_encdec_f32(cfg)
    torch.cuda.empty_cache()
    return counts()


def lm_serving(cfg=None):
    """Phase 3h: LM serving (parts 1-3). Returns the launches of the
    routing SpMM, both of whose bodies must have run."""
    cfg = cfg or get_config(LM_ARCH)
    flops = prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    params, prompt = serve_full_width(cfg, LM_BATCH, LM_PROMPT, LM_NEW,
                                      lambda _: flops)
    launches = routing_spmm(cfg, params, prompt)
    del params
    torch.cuda.empty_cache()
    check_full_width_f32(cfg, {"n_layers": LM_CHECK_LAYERS,
                               "capacity_factor": 16.0}, LM_CHECK_BATCH,
                         LM_CHECK_PROMPT, LM_CHECK_NEW, LM_TOL)
    torch.cuda.empty_cache()
    if not all(launches[k] for k in BODIES[DataflowClass.SPMM]):
        raise AssertionError(f"lm routing: a SpMM body never launched: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------- phase 3j
def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers (bfloat16 and float32 compared by bits,
    signed zeros and NaNs included)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def train_bound(cfg, params, batch, seq):
    """The least time of one train step, by operations (the state read
    and written once is a few ms of bytes): the bf16 matmuls, 6 per param
    per token (the tied table as the head), the remat's second forward of
    the blocks (2 per block param per token) and the loss chunks' head
    recompute (2·d·V per token), at the bf16 tensor-core peak; then
    flash's float32 einsums on the CUDA cores: 9 passes of 2·B·S²·H·dh in
    every attention layer (2 forward, 2 in the remat, 5 in backward: the
    scores again, dV, dP, dQ, dK), every chunk computed, masked or not, as
    in JAX. Returns (bound ms, its parts)."""
    tokens = batch * seq
    leaves, block_leaves = [], []
    tree_map(leaves.append, params)
    tree_map(block_leaves.append, {k: params[k] for k in ("blocks", "tail")})
    n, n_blocks = (sum(t.numel() for t in ls) for ls in (leaves,
                                                         block_leaves))
    n_attn = sum(k in lm.ATTENTION_KINDS for k in cfg.layer_kinds())
    parts = {
        "matmul_flops": 6.0 * n * tokens,
        "remat_flops": 2.0 * n_blocks * tokens,
        "loss_head_flops": 2.0 * cfg.d_model * lm.padded_vocab(cfg) * tokens,
        "flash_f32_flops": 9 * n_attn * 2.0 * batch * seq * seq
        * cfg.n_heads * cfg.d_head,
    }
    bf16 = parts["matmul_flops"] + parts["remat_flops"] + parts[
        "loss_head_flops"]
    parts["bf16_ms"] = bf16 / BF16_FLOPS_PER_S * 1e3
    parts["flash_f32_ms"] = parts["flash_f32_flops"] / F32_FLOPS_PER_S * 1e3
    return parts["bf16_ms"] + parts["flash_f32_ms"], parts


def timed_step(step, state, batch):
    """One train step, host clock ending in a synchronize; its metrics read
    on the host."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, metrics = step(state, batch)
    vals = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    return state, vals, (time.perf_counter() - t1) * 1e3


def train_full_width(cfg):
    """Phase 3j (a): ``cfg`` at full width and depth in bf16, trained on
    the card: 8 steps overfitting one batch (the loss falls, every metric
    finite), then the fault-tolerant driver twice from the same initial
    state at ``TRAIN_DRIVER_LAYERS`` deep, once with a failure injected at
    step 5 (one restart, replay from the step-4 checkpoint) and once
    without: the same final loss, and the last checkpoint restores the
    run's final state bit for bit. Returns the 8 steps' losses."""
    dev = torch.device(LM_DEVICE)
    model = build(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=2))
    ds = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=TRAIN_DATA_SEED))

    def to_device(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state0 = init_train_state(model, tcfg,
                              torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t1) * 1e3
    state_bytes = tree_bytes(state0)
    step = make_train_step(model, None, tcfg)
    batch = to_device(ds.batch_at(0))
    state, losses, times = state0, [], []
    for i in range(TRAIN_STEPS):
        state, vals, ms = timed_step(step, state, batch)
        bad = sorted(k for k, v in vals.items() if not math.isfinite(v))
        if bad:
            raise AssertionError(f"train {cfg.name}: step {i} metrics {bad} "
                                 f"not finite: {vals}")
        losses.append(vals["loss"])
        times.append(ms)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {cfg.name}: the loss did not fall over "
                             f"{TRAIN_STEPS} steps on one batch: {losses}")
    peak = torch.cuda.max_memory_allocated()
    profile = profile_run(lambda: step(state, batch), top=8)
    del state
    bound_ms, parts = train_bound(cfg, state0["params"], TRAIN_BATCH,
                                  TRAIN_SEQ)
    step_ms = statistics.median(times[2:])
    log(f"train: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype} params, mixed precision, remat {cfg.remat}, "
        f"{state_bytes / 1e9:.3f} GB of train state; {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step; {TRAIN_STEPS} steps on one batch: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, every metric finite")
    log("train measured: " + json.dumps({
        "arch": cfg.name, "init_ms": init_ms, "step_ms": step_ms,
        "step_ms_range": [min(times[2:]), max(times[2:])],
        "step_ms_all": times, "losses": losses,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "base_mb": base_mem / 2 ** 20,
        "peak_mb_above_base": (peak - base_mem) / 2 ** 20,
        "state_bytes": state_bytes, "step_bound_ms": bound_ms,
        "bound_parts": parts}))
    log(f"profile train {cfg.name} step: " + json.dumps(profile))

    # The driver runs at TRAIN_DRIVER_LAYERS deep (full width).
    del state0
    torch.cuda.empty_cache()
    dmodel = build(dataclasses.replace(cfg, n_layers=TRAIN_DRIVER_LAYERS))
    state0 = init_train_state(
        dmodel, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    ckpt_bytes = tree_bytes(state0)
    step = make_train_step(dmodel, None, tcfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        last = {}

        def kept(s, b):
            s, m = step(s, b)
            last["state"] = s
            return s, m

        def drive(name, fail_at):
            d = TrainDriver(DriverConfig(total_steps=TRAIN_STEPS,
                                         checkpoint_every=TRAIN_CKPT_EVERY,
                                         checkpoint_dir=os.path.join(tmp,
                                                                     name)),
                            kept, ds, to_device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            report = d.run(state0, fail_at=fail_at, device=dev)
            torch.cuda.synchronize()
            if latest_step(d.cfg.checkpoint_dir) != TRAIN_STEPS:
                raise AssertionError(f"train driver {name}: latest "
                                     "checkpoint is not the last step")
            return report, (time.perf_counter() - t1) * 1e3

        failed, failed_ms = drive("failed", {TRAIN_FAIL_AT: RuntimeError(
            f"injected failure at step {TRAIN_FAIL_AT}")})
        if failed.restarts != 1:
            raise AssertionError(f"train driver: {failed.restarts} restarts "
                                 "for one injected failure")
        shutil.rmtree(os.path.join(tmp, "failed"))
        clean, clean_ms = drive("clean", None)
        a, b = failed.final_metrics["loss"], clean.final_metrics["loss"]
        if abs(a - b) > 1e-6 * abs(b):
            raise AssertionError(f"train driver: loss {a} after a restart, "
                                 f"{b} without")
        restored, manifest = restore(os.path.join(tmp, "clean"), state0,
                                     device=dev)
        n_leaves, n_bf16 = 0, 0

        def same(x, y):
            nonlocal n_leaves, n_bf16
            n_leaves += 1
            n_bf16 += x.dtype == torch.bfloat16
            if x.dtype != y.dtype or not torch.equal(bits(x), bits(y)):
                raise AssertionError("train checkpoint: a restored leaf "
                                     "differs from the run's final state")

        tree_map(same, restored, last["state"])
        del restored, last
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"train driver: {dmodel.cfg.n_layers} layers at full width, "
        f"{TRAIN_STEPS} steps, checkpoint every "
        f"{TRAIN_CKPT_EVERY}: a failure at step {TRAIN_FAIL_AT} -> "
        f"{failed.restarts} restart, final loss {a!r}; without it {b!r} "
        f"({'the same bits' if a == b else f'{abs(a - b) / abs(b):.3e} rel'}"
        f"); step {manifest['step']}'s checkpoint restored bit for bit "
        f"({n_leaves} leaves, {n_bf16} bf16)")
    log("train driver measured: " + json.dumps({
        "failed_run_ms": failed_ms, "clean_run_ms": clean_ms,
        "restarts": failed.restarts, "stragglers": [failed.stragglers,
                                                    clean.stragglers],
        "final_loss": [a, b], "layers": dmodel.cfg.n_layers,
        "checkpoint_bytes": ckpt_bytes}))
    return losses


def check_train_grads_f32(cfg):
    """Phase 3j (b): ``cfg`` at full width with 2 layers in float32: one
    train step's grads through flash's ``autograd.Function`` under
    ``remat="block"`` against plain autograd through the forward-only chunk
    loop under ``remat="none"``, each leaf within ``TRAIN_GRAD_TOL`` of its
    largest magnitude."""
    dev = torch.device(LM_DEVICE)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              n_layers=TRAIN_CHECK_LAYERS)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size,
                         (TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def plain_flash(q, k, v, causal, window, chunk, scale):
        return lm_flash._fwd(q, k, v, causal, window, chunk, scale)[0]

    def grads(remat, flash):
        lfn = make_loss_fn(build(dataclasses.replace(cfg, remat=remat)),
                           None, TrainConfig())
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = []
        tree_map(leaves.append, live)
        was = lm_layers.flash_attention
        lm_layers.flash_attention = flash
        try:
            loss, _ = lfn(live, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        finally:
            lm_layers.flash_attention = was

    loss, got = grads("block", lm_flash.flash_attention)
    want_loss, want = grads("none", plain_flash)
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    if worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"train f32 {cfg.name}: grads {worst:.3e} of "
                             "their largest magnitude from plain autograd's")
    log(f"train f32: {cfg.name} at full width, {cfg.n_layers} layers, "
        f"{TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ} tokens: {len(got)} grad "
        f"leaves through the Function and remat within {worst:.3e} of their "
        f"largest magnitude from plain autograd through the chunk loop (tol "
        f"{TRAIN_GRAD_TOL}); loss {float(loss)!r} against {float(want_loss)!r}")


def flash_alone():
    """Phase 3j (c): flash at one full-width layer's shape in bf16:
    forward and backward ms, the bytes the Function keeps for backward
    (exactly q, k, v, out, lse), and ``scaled_dot_product_attention``'s
    forward + backward at the same shape as a yardstick (never on the
    path)."""
    dev = torch.device(LM_DEVICE)
    b, s, kvh, g, dh = FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(FLASH_SHAPE, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kvh, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = dh ** -0.5

    def fwd(*xs):
        return lm_flash.flash_attention(*xs, True, None, FLASH_CHUNK, scale)

    fwd_ms = time_ms(lambda: fwd(q, k, v), 3)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    kept = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: kept.append(nbytes(x)) or x, lambda x: x):
        out = fwd(qg, kg, vg)
    five = nbytes(q, k, v, out) + b * s * kvh * g * 4
    if sum(kept) != five:
        raise AssertionError(f"flash keeps {sum(kept)} bytes for backward, "
                             f"not the {five} of q, k, v, out, lse")
    dout = torch.randn(out.shape, generator=gen, device=dev,
                       dtype=out.dtype)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), dout, retain_graph=True), 3)
    heads = [x.detach().reshape(b, s, -1, dh).transpose(1, 2)
             .repeat_interleave(g if x is not q else 1, dim=1)
             .requires_grad_() for x in (q, k, v)]
    do_s = dout.reshape(b, s, -1, dh).transpose(1, 2)

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(
            *heads, is_causal=True, scale=scale)
        return torch.autograd.grad(o, heads, do_s)

    sdpa_ms = time_ms(sdpa, 5)
    pass_flops = 2.0 * b * s * s * kvh * g * dh
    log("train flash measured: " + json.dumps({
        "shape": list(FLASH_SHAPE), "chunk": FLASH_CHUNK,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "saved_bytes": sum(kept), "saved_tensors": len(kept),
        "forward_bound_ms": 2 * pass_flops / F32_FLOPS_PER_S * 1e3,
        "backward_bound_ms": 5 * pass_flops / F32_FLOPS_PER_S * 1e3,
        "sdpa_fwd_bwd_ms": sdpa_ms}))


def launcher_run():
    """Phase 3j (d): ``repro_torch.launch.train.main`` on the card, the
    reduced preset for 8 steps."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        t1 = time.perf_counter()
        report = train_launch.main(["--preset", "reduced", "--steps", "8",
                                    "--ckpt-dir", tmp],
                                   device=torch.device(LM_DEVICE))
        wall_ms = (time.perf_counter() - t1) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if report.steps_run != 8 or not math.isfinite(
            report.final_metrics["loss"]):
        raise AssertionError(f"launcher: {report}")
    log(f"train launcher: 8 reduced steps in {wall_ms:.1f} ms, final loss "
        f"{report.final_metrics['loss']!r}")


def lm_training(cfg=None):
    """Phase 3j: training at full width (a), the float32 grads (b), flash
    alone (c) and the launcher (d). Returns the kernels' launches (the
    path runs none of the nine) and (a)'s losses."""
    reset_counts()
    cfg = cfg or get_config(TRAIN_ARCH)
    losses = train_full_width(cfg)
    torch.cuda.empty_cache()
    check_train_grads_f32(cfg)
    torch.cuda.empty_cache()
    flash_alone()
    torch.cuda.empty_cache()
    launcher_run()
    torch.cuda.empty_cache()
    return counts(), losses


# ---------------------------------------------------------------- phase 3k
def start_dryruns():
    """Phase 3k (c), started first so that it runs on the host's cores
    while the card works: one ``python -m repro_torch.launch.dryrun``
    subprocess per cell of ``DRYRUN_CELLS``, each writing its record under
    ``chiprun_out/dryrun``."""
    import threading

    out = ROOT / "chiprun_out" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh, _ in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out)]
        run = {"t0": time.perf_counter(), "proc": subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)}

        def wait(run=run):
            try:
                run["err"] = run["proc"].communicate(
                    timeout=DRYRUN_TIMEOUT_S)[1]
            except subprocess.TimeoutExpired:
                run["proc"].kill()
                run["err"] = f"over {DRYRUN_TIMEOUT_S} s"
                run["proc"].communicate()
            run["wall_s"] = time.perf_counter() - run["t0"]

        run["waiter"] = threading.Thread(target=wait, daemon=True)
        run["waiter"].start()
        procs.append(run)
    return out, procs


def finish_dryruns(out, procs):
    """Phase 3k (c): each dry-run cell ends ``ok`` on its mesh's
    ``devices``; its FLOPs, bytes, collectives by kind, ``dominant`` and
    the subprocess's wall (start to exit), printed."""
    for (arch, shape, mesh, devices), run in zip(DRYRUN_CELLS, procs):
        run["waiter"].join()
        proc, err, wall_s = run["proc"], run["err"], run["wall_s"]
        if proc.returncode != 0:
            raise AssertionError(f"dry run {arch} x {shape}: exit "
                                 f"{proc.returncode}: {err[-2000:]}")
        with open(out / mesh / f"{arch.replace('.', '_')}__{shape}.json") as f:
            rec = json.load(f)
        if not rec.get("ok") or rec["devices"] != devices:
            raise AssertionError(f"dry run {arch} x {shape}: {rec}")
        log(f"dryrun {mesh} {arch} x {shape}: ok on {rec['devices']} "
            f"devices, {rec['flops_per_device']:.4e} FLOP and "
            f"{rec['bytes_per_device']:.4e} bytes a device, dominant "
            f"{rec['roofline']['dominant']}, subprocess {wall_s:.1f} s")
        log("dryrun measured: " + json.dumps({
            "arch": arch, "shape": shape, "mesh": mesh,
            "subprocess_s": wall_s, "trace_s": rec["trace_s"],
            "flops_per_device": rec["flops_per_device"],
            "flops_by_dtype": rec["flops_by_dtype"],
            "bytes_per_device": rec["bytes_per_device"],
            "collective_ops": rec["collective"]["ops"],
            "collective_result_bytes": rec["collective"]["result_bytes"],
            "link_bytes_per_chip": rec["collective"]["ici_bytes_per_chip"],
            "roofline": rec["roofline"], "memory": rec["memory"],
            "model_flops_ratio": rec["model_flops_ratio"]}))


def mesh_axes(mesh, **kw) -> lm_layers.Axes:
    return lm_layers.Axes(batch=mesh_mod.batch_axes(mesh), model="model",
                          fsdp="data",
                          sizes=tuple(mesh_mod.axis_sizes(mesh).items()),
                          **kw)


def mesh_train(cfg, want_losses):
    """Phase 3k (a): phase 3j's training, the same config, seed and batch,
    through ``launch.train``'s mesh path on a ``DeviceMesh`` of one device
    (the state sharded by ``param_pspecs`` and ``state_specs``, every
    placement ``Replicate`` at size 1, the batch over the batch axes,
    ``grad_pspecs`` set): under ``remat="block"`` and ``"block_save"`` the
    first losses equal phase 3j's (bits printed); for ``block_save`` the
    step ms, peak memory and busy share, and the op analysis of one step
    on the card against the measured step."""
    dev = torch.device(LM_DEVICE)
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), dev.type)
    sizes = mesh_mod.axis_sizes(mesh)
    axes = mesh_axes(mesh)
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=2))
    ds = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=TRAIN_DATA_SEED))
    bsh = sharding.NamedSharding(mesh, sharding.P(mesh_mod.batch_axes(mesh)))
    batch = {k: sharding.shard_tensor(torch.from_numpy(v).to(dev), bsh)
             for k, v in ds.batch_at(0).items()}
    report = {}
    for remat, n in (("block", MESH_BLOCK_STEPS), ("block_save",
                                                   MESH_SAVE_STEPS)):
        model = build(dataclasses.replace(cfg, remat=remat))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        state0 = init_train_state(
            model, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
        pspecs = sharding.param_pspecs(state0["params"], sizes)
        state = sharding.distribute(state0, sharding.named_shardings(
            train_launch.state_specs(state0, pspecs), mesh))
        del state0
        step = make_train_step(model, axes, tcfg, grad_pspecs=pspecs)
        losses, times = [], []
        with mesh_mod.set_mesh(mesh):
            for _ in range(n):
                state, vals, ms = timed_step(step, state, batch)
                losses.append(vals["loss"])
                times.append(ms)
            peak = torch.cuda.max_memory_allocated()
            same = [a == b for a, b in zip(losses, want_losses)]
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(losses, want_losses))
            if worst > MESH_LOSS_RTOL:
                raise AssertionError(
                    f"mesh train {remat}: losses {losses} against phase "
                    f"3j's {want_losses[:n]} ({worst:.3e} rel)")
            log(f"mesh train {remat}: {cfg.name} on a 1x1 DeviceMesh, "
                f"{n} steps: losses {losses} against phase 3j's "
                f"{want_losses[:n]}: "
                + ("the same bits" if all(same) else
                   f"{worst:.3e} rel (tol {MESH_LOSS_RTOL})"))
            report[remat] = {"losses": losses,
                             "loss_bits": [x.hex() for x in losses],
                             "same_bits": same,
                             "step_ms_all": times,
                             "peak_mb_above_base": (peak - base_mem) / 2 ** 20}
            if remat != "block_save":
                del state
                continue
            profile = profile_run(lambda: step(state, batch), top=8)
            counter = op_analysis.OpCounter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with counter:
                step(state, batch)
                torch.cuda.synchronize()
            counted_ms = (time.perf_counter() - t1) * 1e3
        del state
        coll = op_analysis.collective_stats(counter)
        flops = op_analysis.dot_flops(counter)
        nbytes_ = op_analysis.memory_bytes(counter)
        rl = op_analysis.roofline_terms(flops, nbytes_,
                                        coll.ici_bytes_per_chip)
        step_ms = statistics.median(times[1:])
        log(f"mesh train block_save: step {step_ms:.2f} ms (median of steps "
            f"2-{n}), busy {profile['device_busy_ms']:.1f} ms of "
            f"{profile['wall_ms']:.1f}; op analysis of one step: "
            f"{flops:.4e} FLOP {dict(counter.flops_by_dtype)}, "
            f"{nbytes_:.4e} bytes, dominant {rl.dominant}")
        report["block_save"].update({
            "step_ms": step_ms,
            "step_ms_range": [min(times[1:]), max(times[1:])],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "profile": profile, "counted_step_ms": counted_ms,
            "op_flops": flops, "op_flops_by_dtype": dict(
                counter.flops_by_dtype),
            "op_bytes": nbytes_, "op_collectives": coll.ops,
            "op_peak_live_bytes": counter.peak_live,
            "roofline_ms": {"compute": rl.compute_s * 1e3,
                            "memory": rl.memory_s * 1e3,
                            "collective": rl.collective_s * 1e3,
                            "dominant": rl.dominant},
            "top_bytes_ops": op_analysis.memory_breakdown(counter)[:6]})
    log("mesh train measured: " + json.dumps(report))


def seeded_cache(cache, pos: int, gen):
    """``cache``'s K/V rows before ``pos`` drawn from N(0, 0.1²) in place,
    as ``tests/test_sharded.py``'s context-parallel test fills its cache
    (a leaf at a time: no float32 temporary)."""
    def fill(t):
        if t.ndim >= 4:
            rows = t[..., :pos, :, :]
            rows.copy_(torch.randn(rows.shape, generator=gen,
                                   device=t.device, dtype=t.dtype) * 0.1)
        return t

    tree_map(fill, cache)
    return cache


def cp_decode(cfg, dtype: str, timed: bool):
    """Phase 3k (b): ``cfg`` at full width and depth with ``dtype`` params,
    a bf16 ``init_cache(1, CP_S_MAX)`` filled before the position from a
    seed: ``CP_STEPS`` decode steps at positions past the sliding window
    near the end of the cache, context-parallel (``cache_pspecs(seq_shard=
    True)``, ``Axes(seq="data")`` on a one-device mesh: the shard's local
    scores, the max and sum all-reduces) against plain ``decode_step`` on
    the same cache. Returns (max |logit diff|, max |logit|, CP step ms,
    plain step ms, peak MiB above base)."""
    dev = torch.device(LM_DEVICE)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    pos0 = CP_S_MAX - CP_STEPS - 4
    gen = torch.Generator(device=dev).manual_seed(1)
    cache = seeded_cache(model.init_cache(1, CP_S_MAX, dtype=torch.bfloat16,
                                          device=dev), pos0, gen)
    mesh = mesh_mod.make_mesh((1,), ("data",), dev.type)
    axes = lm_layers.Axes(batch=(), model="model", fsdp="data", seq="data",
                          sizes=tuple(mesh_mod.axis_sizes(mesh).items()))
    csh = sharding.named_shardings(sharding.cache_pspecs(
        cache, (), mesh_mod.axis_sizes(mesh), seq_shard=True), mesh)
    cp_step = engine.make_decode_step(model, axes)
    plain_step = engine.make_decode_step(model, None)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    worst = scale = 0.0
    cp_ms, plain_ms = [], []
    with mesh_mod.set_mesh(mesh), torch.no_grad():
        for i in range(CP_STEPS):
            pos = torch.tensor([pos0 + i], device=dev, dtype=torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref_lg, _ = plain_step(params, cache, tok, pos)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            lg, new = cp_step(params, sharding.distribute(cache, csh), tok,
                              pos)
            lg = lg.full_tensor()
            torch.cuda.synchronize()
            cp_ms.append((time.perf_counter() - t1) * 1e3)
            new = tree_map(lambda t: t.to_local(), new)
            worst = max(worst, float((lg.float() - ref_lg.float()).abs()
                                     .max()))
            scale = max(scale, float(ref_lg.float().abs().max()))
            cache = new
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    peak = torch.cuda.max_memory_allocated()
    del cache, new, params
    return (worst, scale, statistics.median(cp_ms[1:] if timed else cp_ms),
            statistics.median(plain_ms[1:] if timed else plain_ms),
            (peak - base_mem) / 2 ** 20, cp_ms, plain_ms)


def long_context_decode(cfg):
    """Phase 3k (b) twice: bf16 params (the card's serving dtype: timed,
    the logits within bf16's normwise tolerance) and float32 params (the
    same bf16 cache: the logits within ``CP_TOL`` of plain decode)."""
    cache_bytes = (2 * cfg.n_layers * CP_S_MAX * cfg.n_kv_heads
                   * cfg.d_head * 2)
    weight_bytes = cfg.param_count() * 2
    bound_ms = (cache_bytes + weight_bytes) / HBM_BYTES_PER_S * 1e3
    out = {}
    for dtype, tol, norm in (("bfloat16", TOL["bfloat16"], True),
                             ("float32", CP_TOL, False)):
        worst, scale, cp, plain, peak, cps, plains = cp_decode(
            cfg, dtype, dtype == "bfloat16")
        lim = tol * max(1.0, scale) if norm else tol
        if not worst <= lim:
            raise AssertionError(f"cp decode {dtype}: logits {worst:.3e} "
                                 f"from plain decode (tol {lim:.3e})")
        log(f"cp decode: {cfg.name} {dtype} params, bf16 cache of "
            f"{CP_S_MAX} positions ({cache_bytes / 1e9:.2f} GB), "
            f"{CP_STEPS} steps near the end: logits within {worst:.3e} of "
            f"plain decode (tol {lim:.3e}{', normwise' if norm else ''}); "
            f"step {cp:.2f} ms (plain {plain:.2f}) against its "
            f"{bound_ms:.2f} ms bound; peak {peak:.0f} MiB above base")
        out[dtype] = {"max_abs_diff": worst, "max_abs_logit": scale,
                      "tol": lim, "cp_step_ms": cp, "plain_step_ms": plain,
                      "cp_ms_all": cps, "plain_ms_all": plains,
                      "peak_mb_above_base": peak}
    log("cp decode measured: " + json.dumps({
        "arch": cfg.name, "s_max": CP_S_MAX, "cache_bytes": cache_bytes,
        "weight_bytes_bf16": weight_bytes, "step_bound_ms": bound_ms, **out}))


def lm_mesh(train_losses, cfg=None, cp_cfg=None):
    """Phase 3k: the dry runs started (c), the mesh-path train step (a),
    context-parallel decode at long_500k (b), the dry runs collected.
    Returns the kernels' launches (the path runs none of the nine)."""
    reset_counts()
    out, procs = start_dryruns()
    try:
        mesh_train(cfg or get_config(TRAIN_ARCH), train_losses)
        torch.cuda.empty_cache()
        long_context_decode(cp_cfg or get_config(CP_ARCH))
        torch.cuda.empty_cache()
    finally:
        mesh_mod.shutdown()
    finish_dryruns(out, procs)
    return counts()


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
    # Phase 3g's placements, from the same fleet run without execution.
    fleet_plan = fleet_server(opt, fleet_target(serve_reqs)).run_trace(
        serve_reqs, execute=False)
    log("fleet affinity placement: " + ", ".join(
        f"{ro.rid} {rid} {a.workload.name}: {placement(a)}"
        for ro, rid, a in fleet_assignments(fleet_plan)))

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
    launch_sets += [(f"fleet {ro.rid} {asg.workload.name}", *serve_card[rid],
                     [pp.partition for pp in asg.placed])
                    for ro, rid, asg in fleet_assignments(fleet_plan)]
    redesigned = []
    # Phase 3h's MoE routing: a (T x E) top-k routing of the same shape.
    lm_cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    routing = routing_case(
        f"lm routing {LM_BATCH * LM_PROMPT}x{lm_cfg.n_experts}"
        f"x{lm_cfg.d_model}",
        *synthetic_routing(LM_BATCH * LM_PROMPT, lm_cfg.n_experts,
                           lm_cfg.experts_per_token, gen),
        torch.randn((lm_cfg.n_experts, lm_cfg.d_model), generator=gen,
                    device="cuda"))
    rows.append(routing.check(reps=5))
    redesigned.append((routing, rows[-1]))
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
    serve_launches, serve_wall_ms = serving(opt, serve_reqs, serve_ops,
                                            serve_card, serve_offline)
    log(f"phase 3f serving: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3g: the fleet, a replica killed mid-batch -----------------
    t0 = time.perf_counter()
    fleet_launches = fleet(opt, serve_reqs, serve_ops, serve_card,
                           serve_wall_ms)
    log(f"phase 3g fleet: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3h: LM serving, MoE routing through the SpMM -------------
    t0 = time.perf_counter()
    lm_launches = lm_serving()
    log(f"phase 3h LM serving: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3i: the SSD, RG-LRU and enc-dec archs served -------------
    t0 = time.perf_counter()
    family_launches = lm_families()
    log(f"phase 3i LM families: {time.perf_counter() - t0:.1f} s, "
        f"launches {family_launches}")

    # ---- phase 3j: training at full width --------------------------------
    t0 = time.perf_counter()
    train_launches, train_losses = lm_training()
    log(f"phase 3j LM training: {time.perf_counter() - t0:.1f} s, "
        f"launches {train_launches}")

    # ---- phase 3k: sharding on a mesh, context parallelism, dry runs -----
    t0 = time.perf_counter()
    mesh_launches = lm_mesh(train_losses)
    log(f"phase 3k mesh paths: {time.perf_counter() - t0:.1f} s, "
        f"launches {mesh_launches}")

    # ---- phase 4: the kernels line ---------------------------------------
    launches = {k: single_launches[k] + many_launches[k] + opt_launches[k]
                + stream_launches[k] + serve_launches[k] + fleet_launches[k]
                + lm_launches[k] + family_launches[k] + train_launches[k]
                + mesh_launches[k] for k in REPLACES}
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
