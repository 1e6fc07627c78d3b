"""Training launcher — the port of ``repro.launch.train``: mesh
construction, sharded state init, the fault-tolerant driver over the
port's train step, with the same flags and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --mesh 1x1 --steps 20 --preset reduced --batch 8 --seq 64

``--mesh AxB`` (``A``, ``AxB`` or ``AxBxC``: ``data``, ``data×model``,
``pod×data×model``) builds a ``DeviceMesh`` (``launch.mesh.make_mesh``),
shards the train state by ``param_pspecs`` and the batch over the batch
axes, and runs the driver with those shardings, as JAX's ``main`` does;
``1x1`` goes through the same path on one device. A mesh of more than one
device needs one process a device, started by ``torchrun`` (NCCL on the
cards), or ranks over gloo with ``device="cpu"``:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh 2x4

Enc-dec and VLM archs get the frame and patch-embedding inputs that
``examples/train_lm.py`` builds: normal draws from seeds 1 and 2, the same
every step.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_map
from repro_torch.configs import all_archs, get_config, get_reduced
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.launch.mesh import (
    axis_sizes,
    batch_axes,
    make_mesh,
    set_mesh,
    shutdown,
)
from repro_torch.models import build
from repro_torch.models.layers import Axes
from repro_torch.optim import AdamWConfig, Compressor
from repro_torch.runtime import DriverConfig, DriverReport, TrainDriver
from repro_torch.sharding import (
    NamedSharding,
    P,
    distribute,
    mesh_device,
    named_shardings,
    param_pspecs,
    shard_tensor,
)
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def parse_mesh(spec: str) -> tuple:
    """(dims, axis names) of a ``--mesh`` value, JAX's naming."""
    dims = tuple(int(x) for x in spec.split("x"))
    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(dims)]
    return dims, names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=all_archs())
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_launch_train")
    return ap


def state_specs(state, pspecs) -> dict:
    """JAX's launcher's spec tree of a train state: the optimizer's
    moments and masters as the params, the step and the compression
    residual replicated."""
    return {
        "params": pspecs,
        "opt": {"step": P(), "m": pspecs, "v": pspecs,
                **({"master": pspecs} if "master" in state["opt"] else {})},
        "error": tree_map(lambda _: P(), state["error"]),
    }


def main(argv: Optional[Sequence[str]] = None, device=None) -> DriverReport:
    """Parse ``argv`` (default: the command line), train over the mesh of
    ``--mesh`` on the cards (``device=None``) or on gloo ranks
    (``device="cpu"``), print and return the driver's report. Starts the
    process group if none is started, and then destroys it."""
    args = build_parser().parse_args(argv)
    dims, names = parse_mesh(args.mesh)
    started = not dist.is_initialized()
    mesh = make_mesh(dims, names,
                     None if device is None else torch.device(device).type)
    try:
        return _train(args, mesh)
    finally:
        if started:
            shutdown()


def _train(args, mesh) -> DriverReport:
    dev = mesh_device(mesh)
    sizes = axis_sizes(mesh)
    cfg = (get_reduced(args.arch) if args.preset == "reduced"
           else get_config(args.arch))
    model = build(cfg)
    axes = Axes(batch=batch_axes(mesh), model="model", fsdp="data",
                sizes=tuple(sizes.items()))
    tcfg = TrainConfig(
        optimizer=AdamWConfig(total_steps=args.steps, mixed_precision=False),
        compressor=Compressor(kind=args.compress),
        microbatches=args.microbatches,
        xent_chunk=64,
    )
    state = init_train_state(model, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    pspecs = param_pspecs(state["params"], sizes)
    state_sh = named_shardings(state_specs(state, pspecs), mesh)
    state = distribute(state, state_sh)
    baxes = batch_axes(mesh)
    ds = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq,
                                 global_batch=args.batch))

    def normal(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    def to_device(batch):
        out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b = out["tokens"].shape[0]
        if cfg.family == "encdec":
            enc = int(args.seq * cfg.enc_seq_fraction)
            out["frames"] = normal((b, enc, cfg.d_model), 1)
        if cfg.frontend == "vision_stub":
            out["frontend"] = normal((b, cfg.n_frontend_tokens,
                                      cfg.d_model), 2)
        return {k: shard_tensor(v, NamedSharding(mesh, P(baxes)))
                for k, v in out.items()}

    with set_mesh(mesh):
        driver = TrainDriver(
            DriverConfig(total_steps=args.steps,
                         checkpoint_every=max(args.steps // 4, 1),
                         checkpoint_dir=args.ckpt_dir),
            make_train_step(model, axes, tcfg), ds, to_device)
        report = driver.run(state, shardings=state_sh)
    print(f"steps={report.steps_run} restarts={report.restarts} "
          f"metrics={report.final_metrics}")
    return report


if __name__ == "__main__":
    main()
