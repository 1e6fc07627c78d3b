"""One-card training launcher — the counterpart of ``repro.launch.train``:
the same flags and defaults, state initialised on the card, the
fault-tolerant driver over the port's train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 20 --preset reduced --batch 8 --seq 64

JAX's launcher builds a mesh and shards the state over it; the port runs
on one card, so ``--mesh`` takes a mesh of one device (``1x1``) and raises
for any other (the sharding slice). Enc-dec and VLM archs get the frame and
patch-embedding inputs that ``examples/train_lm.py`` builds: normal draws
from seeds 1 and 2, the same every step.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import all_archs, get_config, get_reduced
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, Compressor
from repro_torch.runtime import DriverConfig, DriverReport, TrainDriver
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def parse_mesh(spec: str) -> tuple:
    """The mesh's dims; only a mesh of one device runs here."""
    dims = tuple(int(x) for x in spec.split("x"))
    if any(d != 1 for d in dims):
        raise NotImplementedError(
            f"--mesh {spec}: repro_torch trains on one card (--mesh 1x1); "
            "sharded meshes come with the sharding slice (ROADMAP.md queue 1 "
            "item 3)")
    return dims


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


def main(argv: Optional[Sequence[str]] = None, device=None) -> DriverReport:
    """Parse ``argv`` (default: the command line), train on ``device``
    (default: the card), print and return the driver's report."""
    args = build_parser().parse_args(argv)
    parse_mesh(args.mesh)
    dev = resolve_device(device)
    cfg = (get_reduced(args.arch) if args.preset == "reduced"
           else get_config(args.arch))
    model = build(cfg)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(total_steps=args.steps, mixed_precision=False),
        compressor=Compressor(kind=args.compress),
        microbatches=args.microbatches,
        xent_chunk=64,
    )
    state = init_train_state(model, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
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
        return out

    driver = TrainDriver(
        DriverConfig(total_steps=args.steps,
                     checkpoint_every=max(args.steps // 4, 1),
                     checkpoint_dir=args.ckpt_dir),
        make_train_step(model, None, tcfg), ds, to_device)
    report = driver.run(state, device=dev)
    print(f"steps={report.steps_run} restarts={report.restarts} "
          f"metrics={report.final_metrics}")
    return report


if __name__ == "__main__":
    main()
