"""Multi-pod dry run — the port of ``repro.launch.dryrun``.

For one (architecture × input shape × mesh) cell: build the right step
(train step, prefill or decode step) on the production mesh with abstract
state, trace it once, and record its per-device FLOPs, bytes, collectives,
roofline terms and memory into ``<out>/<mesh>/<arch>__<shape>.json``, JAX's
record keys in JAX's layout.

The production mesh is torch's fake process group (``launch.mesh
.make_production_mesh``): this process is rank 0 of 256 or 512, and its
collectives communicate nothing. The state and inputs are DTensors over
``meta`` tensors (``Model.abstract_params``), so nothing is allocated;
the step runs once under :class:`~repro_torch.launch.op_analysis
.OpCounter`, which counts each rank-0 op on its local shape. Eager torch
has no lowering or compile, so JAX's ``lower_s``/``compile_s`` become one
``trace_s``, and ``cost_analysis_raw`` (XLA's uncorrected counts) has no
counterpart. ``memory``: the arguments' bytes exact from the local
shards, the outputs', and ``temp_bytes`` as an estimate (the peak of live
intermediate results while the step runs).

Like JAX's, the module sets no process-wide state when imported; the
fake group starts when a cell runs, so run the dry run as its own
process:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch whisper-base --shape decode_32k --mesh multipod --out DIR

A cell of a family that does not yet run sharded (``moe``, ``ssm``,
``recurrent`` on a mesh of more than one device) records ``ok: False``
with the error, as JAX's ``run_cell`` does for a failing cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import all_archs, get_config
from repro_torch.launch import op_analysis as H
from repro_torch.launch.mesh import (
    axis_sizes,
    batch_axes,
    make_production_mesh,
    set_mesh,
)
from repro_torch.models import build
from repro_torch.models.config import SHAPES_BY_NAME, ShapeSpec
from repro_torch.models.layers import Axes
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.serve.engine import make_decode_step
from repro_torch.sharding import (
    NamedSharding,
    P,
    cache_pspecs,
    distribute,
    named_shardings,
    param_pspecs,
    shard_tensor,
)
from repro_torch.train.step import TrainConfig, make_train_step

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")
META = torch.device("meta")


def skip_reason(model: Model, shape: ShapeSpec) -> Optional[str]:
    cfg = model.cfg
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: long_500k needs sub-quadratic "
                "sequence mixing (DESIGN.md §5)")
    return None


def make_axes(mesh, cp: bool = False) -> Axes:
    return Axes(batch=batch_axes(mesh), model="model", fsdp="data",
                seq="data" if cp else None,
                sizes=tuple(axis_sizes(mesh).items()))


def batch_pspecs(structs: Dict[str, torch.Tensor], baxes,
                 sizes: Dict[str, int]):
    dp = 1
    for a in baxes:
        dp *= sizes.get(a, 1)

    def spec(s):
        lead = baxes if s.shape[0] % max(dp, 1) == 0 and s.shape[0] >= dp else None
        return P(lead, *([None] * (len(s.shape) - 1)))

    return {k: spec(v) for k, v in structs.items()}


def _opt_state_specs(pspecs):
    return {
        "step": P(),
        "m": pspecs,
        "v": pspecs,
        "master": pspecs,
    }


def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of a cell (JAX's
    ``ShapeDtypeStruct``s): no allocation."""
    model = build(get_config(arch))
    return {k: torch.empty(shp, dtype=dt, device=META)
            for k, (shp, dt) in model.batch_shapes(
                SHAPES_BY_NAME[shape_name]).items()}


#: §Perf overrides: remat policy + microbatching per arch (train cells).
#: block_save keeps post-collective outputs (skips remat re-all-gathers);
#: microbatch counts bound activation residuals under 16 GB HBM/chip.
TRAIN_TUNING = {
    "dbrx-132b": {"microbatches": 16, "remat": "block"},
    "qwen2.5-3b": {"microbatches": 2},      # 15.2 GB temp at mb=2
    "mamba2-370m": {"microbatches": 2},     # 19.7 GB at mb=1: must split
    "olmoe-1b-7b": {"microbatches": 4, "remat": "block_save"},
    "gemma3-1b": {"remat": "block_save"},
    # llama3.2-3b / recurrentgemma-2b fit at mb=1 (4.0 / 6.1 GB x2):
    # microbatching them only doubles FSDP weight gathers.
}


def lower_cell(arch: str, shape_name: str, mesh) -> Tuple:
    """(step fn, its DTensor arguments on ``mesh``, their shardings,
    donated argument indices) for one cell; the arguments are ``meta``."""
    cfg = get_config(arch)
    tuning = TRAIN_TUNING.get(arch, {})
    if SHAPES_BY_NAME[shape_name].is_train and "remat" in tuning:
        cfg = dataclasses.replace(cfg, remat=tuning["remat"])
    model = build(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    cp = shape.name == "long_500k"      # context-parallel cache (batch=1)
    axes = make_axes(mesh, cp=cp
                     and cfg.family not in ("ssm",))
    params_struct = model.abstract_params()
    pspecs = param_pspecs(params_struct, sizes)

    if shape.is_train:
        microbatches = tuning.get("microbatches", 1)
        tcfg = TrainConfig(
            optimizer=AdamWConfig(mixed_precision=True),
            xent_chunk=512,   # pod-axis DP all-reduce comes from SPMD
            microbatches=microbatches,
        )
        state_struct = {"params": params_struct,
                        "opt": init_state(tcfg.optimizer, params_struct),
                        "error": {}}
        state_specs = {"params": pspecs,
                       "opt": _opt_state_specs(pspecs),
                       "error": {}}
        batch_structs = input_specs(arch, shape_name)
        bspecs = batch_pspecs(batch_structs, baxes, sizes)
        fn = make_train_step(model, axes, tcfg, grad_pspecs=pspecs)
        in_sh = (named_shardings(state_specs, mesh),
                 named_shardings(bspecs, mesh))
        return fn, (state_struct, batch_structs), in_sh, (0,)

    if shape.kind == "prefill":
        from repro_torch.serve.engine import make_prefill

        batch_structs = input_specs(arch, shape_name)
        bspecs = batch_pspecs(batch_structs, baxes, sizes)
        fn = make_prefill(model, axes)
        in_sh = (named_shardings(pspecs, mesh), named_shardings(bspecs, mesh))
        return fn, (params_struct, batch_structs), in_sh, ()

    # decode
    b = shape.global_batch
    s_text = model.text_len(shape.seq_len)
    enc_len = shape.seq_len - s_text if cfg.family == "encdec" else 0
    cache_struct = model.init_cache(
        b, s_text + (cfg.n_frontend_tokens or 0), enc_len=enc_len,
        device=META)
    cspecs = cache_pspecs(cache_struct, baxes, sizes,
                          seq_shard=cp and cfg.family not in ("ssm",))
    tok_struct = torch.empty((b, 1), dtype=torch.int32, device=META)
    pos_struct = torch.empty((b,), dtype=torch.int32, device=META)
    dp = 1
    for a in baxes:
        dp *= sizes.get(a, 1)
    tok_spec = P(baxes, None) if b % dp == 0 and b >= dp else P(None, None)
    pos_spec = P(baxes) if b % dp == 0 and b >= dp else P(None)
    fn = make_decode_step(model, axes)
    in_sh = (named_shardings(pspecs, mesh),
             named_shardings(cspecs, mesh),
             NamedSharding(mesh, tok_spec), NamedSharding(mesh, pos_spec))
    return fn, (params_struct, cache_struct, tok_struct, pos_struct), in_sh, (1,)


def _place(struct, sharding):
    """A ``meta`` tree (or leaf) as DTensors by its shardings."""
    if isinstance(sharding, NamedSharding):
        return shard_tensor(struct, sharding)
    return distribute(struct, sharding)


def _local_bytes(tree) -> int:
    return sum(H.tensor_bytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str, verbose: bool = True,
             save_hlo: bool = False) -> Dict:
    """Dry-run one cell on the production mesh and write its record.
    ``save_hlo`` writes the cell's op table (bytes and count by op,
    collectives by op) beside it, the counterpart of JAX's gzipped HLO."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    cfg = get_config(arch)
    model = build(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_tag = "multipod" if multi_pod else "singlepod"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "devices": int(n_dev)}

    reason = skip_reason(model, shape)
    if reason:
        rec["skipped"] = reason
        _write(out_dir, mesh_tag, arch, shape_name, rec)
        if verbose:
            print(f"[{mesh_tag}] {arch} × {shape_name}: SKIP ({reason})")
        return rec

    t0 = time.time()
    try:
        fn, structs, in_sh, _ = lower_cell(arch, shape_name, mesh)
        args = tuple(_place(s, sh) for s, sh in zip(structs, in_sh))
        counter = H.OpCounter()
        with set_mesh(mesh), counter:
            out = fn(*args)
        t_trace = time.time() - t0

        coll = H.collective_stats(counter)
        flops_dev = H.dot_flops(counter)
        bytes_dev = H.memory_bytes(counter)
        rl = H.roofline_terms(flops_dev, bytes_dev, coll.ici_bytes_per_chip)
        if save_hlo:
            _write_ops(out_dir, mesh_tag, arch, shape_name, counter)

        tokens = shape.global_batch * (shape.seq_len if shape.is_train or
                                       shape.kind == "prefill" else 1)
        mf = H.model_flops(cfg.param_count(), tokens,
                           "train" if shape.is_train else "serve",
                           active_param_count=_active_params(cfg))
        arg_bytes = _local_bytes(args)
        rec.update({
            "ok": True,
            "trace_s": round(t_trace, 2),
            "flops_per_device": flops_dev,
            "flops_by_dtype": dict(counter.flops_by_dtype),
            "bytes_per_device": bytes_dev,
            "collective": {
                "ops": coll.ops,
                "result_bytes": coll.bytes_by_kind,
                "ici_bytes_per_chip": coll.ici_bytes_per_chip,
            },
            "roofline": {
                "compute_s": rl.compute_s,
                "memory_s": rl.memory_s,
                "collective_s": rl.collective_s,
                "dominant": rl.dominant,
            },
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": _local_bytes(out),
                "temp_bytes": int(counter.peak_live),
                "peak_bytes_estimate": arg_bytes + int(counter.peak_live),
            },
            "model_flops_total": mf,
            "model_flops_ratio": (mf / (flops_dev * n_dev)
                                  if flops_dev else 0.0),
        })
        if verbose:
            print(f"[{mesh_tag}] {arch} × {shape_name}: OK "
                  f"trace={t_trace:.1f}s dominant={rl.dominant} "
                  f"comp={rl.compute_s:.2e}s mem={rl.memory_s:.2e}s "
                  f"coll={rl.collective_s:.2e}s")
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[{mesh_tag}] {arch} × {shape_name}: FAIL {type(e).__name__}: {e}")
    _write(out_dir, mesh_tag, arch, shape_name, rec)
    return rec


def _active_params(cfg) -> Optional[int]:
    if cfg.family != "moe":
        return None
    dense = cfg.param_count()
    expert_all = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    expert_active = cfg.n_layers * cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff
    return dense - expert_all + expert_active


def _write(out_dir, mesh_tag, arch, shape_name, rec):
    d = os.path.join(out_dir, mesh_tag)
    os.makedirs(d, exist_ok=True)
    fname = f"{arch.replace('.', '_')}__{shape_name}.json"
    with open(os.path.join(d, fname), "w") as f:
        json.dump(rec, f, indent=1)


def _write_ops(out_dir, mesh_tag, arch, shape_name, counter):
    import gzip

    d = os.path.join(out_dir, mesh_tag)
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(
            d, f"{arch.replace('.', '_')}__{shape_name}.ops.json.gz"),
            "wt") as fh:
        json.dump({"memory": H.memory_breakdown(counter),
                   "collectives": H.collective_breakdown(counter)}, fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["singlepod", "multipod", "both"],
                    default="both")
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the op table per cell (gzipped JSON)")
    args = ap.parse_args(argv)

    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape])
    meshes = (["singlepod", "multipod"] if args.mesh == "both"
              else [args.mesh])
    failures = 0
    for mesh_tag in meshes:
        for arch in archs:
            for shape_name in shapes:
                path = os.path.join(
                    args.out, mesh_tag,
                    f"{arch.replace('.', '_')}__{shape_name}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        old = json.load(f)
                    if old.get("ok") or old.get("skipped"):
                        continue
                rec = run_cell(arch, shape_name, mesh_tag == "multipod",
                               args.out, save_hlo=args.save_hlo)
                if not (rec.get("ok") or rec.get("skipped")):
                    failures += 1
        _end_group()
    print(f"dry-run complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


def _end_group():
    """The next mesh needs a fake group of its own size."""
    from repro_torch.launch.mesh import shutdown

    shutdown()


if __name__ == "__main__":
    main()
