"""Find a cell's parts by name: BENCHMARK.json, the configuration file,
the traffic mix and its generator, the metric readers, the reference."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: The folder of the benchmark, and the checkout root above it.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names, all looked up
    under ``root / "portbench"``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def generator(self, kind: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{kind}.py",
                           f"portbench_traffic_{kind}")

    def reference(self, name: str) -> ModuleType:
        return load_module(self.dir / "references" / f"{name}.py",
                           f"portbench_reference_{name}")

    def reference_limits(self, name: str) -> Dict[str, float]:
        path = self.dir / "references" / f"{name}.json"
        return json.loads(path.read_text())["limits"]

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on. A metric with a
        ``workloads`` list applies to those cells only; a per-layer metric
        without one applies wherever its ``moves`` metric does."""
        e2e = {m["name"]: m for m in self.spec["end_to_end"]}

        def applies(m: Dict) -> bool:
            if "workloads" in m:
                return cell in m["workloads"]
            if "moves" in m:
                return applies(e2e[m["moves"]])
            return True

        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if applies(m)]

    def reader(self, metric: str):
        """The ``read(record)`` function of ``metrics/<metric>.py``; a
        metric split by cells (``queue_ms.small``) without a file of its
        own is read by the file of the name before its first dot."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path, "portbench_metric_"
                           + path.stem.replace(".", "_")).read
