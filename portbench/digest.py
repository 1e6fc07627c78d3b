"""A digest of the outputs a cell's first units give for one seed: run it
in two checkouts (with the same benchmark files laid over both) to see
that a change leaves a cell's answers bit for bit.

    python3 portbench/digest.py --workload <cell> --seed <n> --units <k>

Prints one JSON line: the cell, the seed, the units, the SHA-256 of the
outputs' bytes in order, and the device."""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def digest(cell: str, seed: int, units: int, device, root=ROOT) -> str:
    import torch

    from portbench.spec import Bench

    bench = Bench(root)
    spec = bench.cell(cell)
    config = bench.config(spec["config"])
    mix = bench.traffic(spec["traffic"])
    dev = torch.device(device)
    traffic = bench.generator(mix["kind"]).Traffic(mix, config, None, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    traffic.prepare(gen)
    h = hashlib.sha256()
    for i in range(units):
        for t in traffic.run(i % traffic.n_sets):
            t = t.detach().contiguous().cpu()
            h.update(t.view(torch.uint8).numpy().tobytes()
                     if t.dim() else t.reshape(1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and str(Path(p).resolve()) != here]
    import torch

    dev = "cpu" if args.cpu else "cuda"
    out = {"cell": args.workload, "seed": args.seed, "units": args.units,
           "sha256": digest(args.workload, args.seed, args.units, dev),
           "device": (torch.cuda.get_device_name(0) if dev == "cuda"
                      else "cpu")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
