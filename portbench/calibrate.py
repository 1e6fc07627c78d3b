"""Readings that the limits of ``references/*.json`` are set from: for a
cell and each seed, the numbers compared for the program (the lower
reading), and for the control, the reference in the program's place one
precision below (the upper reading). A queue's reading is one unit on
each operand set. Where the reference gives ``control_outputs`` (a
served model), the reading is a run's own (``cell.run``, a window of
``--seconds``): the sample its check judged, and the control's answers
for the same units. One process for all seeds: the imports are paid
once.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ...

Prints one JSON line a seed and side; on the card unless ``--cpu``."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seeds, device, root=ROOT, out=print,
             seconds: float = 10.0):
    import torch

    from repro_torch.core import costmodel

    from portbench.spec import Bench

    bench = Bench(root)
    spec = bench.cell(cell)
    config = bench.config(spec["config"])
    mix = bench.traffic(spec["traffic"])
    accel = (costmodel.config_from_json(config["accelerator"])
             if "accelerator" in config else None)
    reference = bench.reference(config["reference"])
    limits = bench.reference_limits(config["reference"])
    if hasattr(reference, "control_outputs"):
        return [row for seed in seeds for row in _served(
            cell, seed, seconds, reference, limits, device, root, out)]
    dev = torch.device(device)
    rows = []
    for seed in seeds:
        traffic = bench.generator(mix["kind"]).Traffic(mix, config, accel,
                                                       dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        traffic.prepare(gen)
        for side in ("program", "control"):
            outs, handed = [], []
            for s in range(traffic.n_sets):
                pairs = traffic.operands(s)
                outs += (traffic.run(s) if side == "program" else
                         [reference.control(a, b, dev) for a, b in pairs])
                handed += pairs
            nums, per_task = reference.readings(outs, handed, dev)
            del outs
            names = [t.name for t in traffic.tasks] * traffic.n_sets
            row = {"cell": cell, "seed": seed, "side": side, **nums,
                   "limits": limits,
                   "per_task": [[n, t] for n, t in zip(names, per_task)]}
            rows.append(row)
            out(json.dumps(row))
        # Drop this seed's operands before the next seed's are drawn, so
        # that two seeds' sets never share the card.
        del pairs, handed, traffic
    return rows


def _served(cell, seed, seconds, reference, limits, device, root, out):
    """The sample a run's check judged, for the program, and the
    control's answers for the same units, judged alike."""
    from portbench.cell import run

    rows = []

    def judged(outputs, handed, nums):
        control = reference.control_outputs(outputs, handed, device)
        for side, got in (("program", nums), ("control", reference.readings(
                control, handed, device)[0])):
            row = {"cell": cell, "seed": seed, "side": side, **got,
                   "limits": limits}
            rows.append(row)
            out(json.dumps(row))

    run(cell, seed, seconds, False, device=device, root=root,
        log=lambda msg: None, judged=judged)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="a served model's window")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and str(Path(p).resolve()) != here]
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    readings(args.workload, args.seeds, "cpu" if args.cpu else "cuda",
             seconds=args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
