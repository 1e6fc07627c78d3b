"""Faults planted in the latent-attention decode step of the port, each
run through a whole cell (``cell.run``), to show which limit of the
cell's reference catches it:

* ``unchanged``: the step's cache inserts write copies, so the cache it
  was given, written in place and returned, stays as it was;
* ``no_rope_score``: the decode scores leave out ``q_pe·k_pe``;
* ``latent_before_norm``: the step caches (and attends) the latent before
  its RMSNorm;
* ``plain_rope``: RoPE at the plain frequencies in place of YaRN's,
  prefill and decode alike.

    python3 portbench/mla_faults.py --workload <cell> --seed <n> \\
        --seconds <s> [--faults ...]

Prints one JSON line a fault: ``correct`` and each compared number beside
its limit. On the card unless ``--cpu``."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("unchanged", "no_rope_score", "latent_before_norm", "plain_rope")


@contextlib.contextmanager
def planted(fault: str):
    """The port with ``fault`` planted, for the duration."""
    import torch

    from repro_torch.models import layers, mla

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    if fault == "unchanged":
        real_insert = layers._cache_insert

        def insert(cache, kv, pos, in_place=False):
            return real_insert(cache, kv, pos)

        patch(layers, "_cache_insert", insert)
    elif fault == "no_rope_score":
        real_attend = mla.absorbed_attend

        def attend(q_nope, q_pe, *rest):
            return real_attend(q_nope, torch.zeros_like(q_pe), *rest)

        patch(mla, "absorbed_attend", attend)
    elif fault == "latent_before_norm":
        real_project, real_decode = mla._project, mla.mla_decode

        def raw(p, x, cfg, *tables):
            q_nope, q_pe, _, k_pe = real_project(p, x, cfg, *tables)
            kva = torch.einsum("bsd,de->bse", x, p["wkv_a"])
            return q_nope, q_pe, kva[..., :cfg.kv_lora_rank], k_pe

        def decode(*args, **kwargs):
            mla._project = raw
            try:
                return real_decode(*args, **kwargs)
            finally:
                mla._project = real_project

        patch(mla, "mla_decode", decode)
    elif fault == "plain_rope":
        real_freq = mla.inv_freq

        def plain(cfg, device=None):
            import dataclasses
            return real_freq(dataclasses.replace(cfg, yarn_factor=0.0),
                             device)

        patch(mla, "inv_freq", plain)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and str(Path(p).resolve()) != here]
    from portbench import cell

    for fault in args.faults:
        with planted(fault):
            r = cell.run(args.workload, args.seed, args.seconds, False,
                         device="cpu" if args.cpu else "cuda", root=ROOT,
                         log=lambda msg: None)
        print(json.dumps({"fault": fault, "seed": args.seed,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
