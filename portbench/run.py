"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
are the same checks. Exits 1 without printing a result when the port is
not beside the benchmark, when there is no card or too few, or when JAX,
Flax or the JAX package is loaded once the window has closed."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Every build and kernel cache at a fixed place inside the checkout, so
#: that only a checkout's first run builds.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    # The script's own folder is not a package root: only ``portbench.*``.
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and str(Path(p).resolve()) != here]
    import torch

    from portbench.spec import Bench

    try:
        import repro_torch
    except ImportError as e:
        return fail(f"the port is not beside the benchmark: {e}")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT):
        return fail(f"repro_torch imported from {repro_torch.__file__}, "
                    f"not from this checkout ({ROOT})")
    chips = int(Bench(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available():
        return fail("no CUDA device; the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} found")

    from portbench import cell

    return report(cell.run(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", root=ROOT,
                           t_start=T_START))


def report(result) -> int:
    """Print the result line, unless JAX, Flax or the JAX package has
    been loaded into this process."""
    from portbench import guard

    found = guard.loaded()
    if found:
        return fail(f"forbidden modules loaded: {found}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
