"""What every traffic generator shares: the task list of a mix, resolved
against its own templates and the configuration's workloads, and the two
operand sets drawn from the seed, with their work."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from portbench import operands, work


@dataclass(frozen=True)
class Task:
    """One matmul: A (m x k, density d_mk) times B (k x n, density d_kn)."""

    name: str
    m: int
    k: int
    n: int
    d_mk: float
    d_kn: float


def task(name: str, mix: Dict, config: Dict) -> Task:
    """The task ``name``: a template of the mix, else a workload of the
    configuration."""
    d = mix.get("templates", {}).get(name) or config.get(name)
    if d is None:
        raise KeyError(f"task {name!r} is neither a template of the mix "
                       "nor a workload of the configuration")
    return Task(name, int(d["m"]), int(d["k"]), int(d["n"]),
                float(d["d_mk"]), float(d["d_kn"]))


class Traffic:
    """A closed loop over units of work (a queue), alternating
    between ``operand_sets`` sets of operands so that no call is handed
    the arrays of the call before. A generator subclasses this and
    defines :meth:`run`."""

    unit = "queue"

    def __init__(self, mix: Dict, config: Dict, accel, device):
        self.mix, self.config, self.accel = mix, config, accel
        self.device = torch.device(device)
        self.dtype = operands.DTYPES[config["dtype"]]
        self.tasks: List[Task] = [task(n, mix, config) for n in self.names()]
        self.n_sets = int(mix.get("operand_sets", 2))
        self.sets: List[List] = []
        self.works: List[List[work.Work]] = []

    def names(self) -> Sequence[str]:
        return self.mix["tasks"]

    def prepare(self, gen: torch.Generator) -> None:
        """Draw every operand set from ``gen`` and count its work."""
        for _ in range(self.n_sets):
            pairs = operands.draw_pairs(self.tasks, gen, self.dtype)
            self.works.append([work.task_work(a, b) for a, b in pairs])
            self.sets.append(pairs)

    def run(self, s: int) -> List[torch.Tensor]:
        """One unit on operand set ``s``; its outputs in task order, not
        yet synchronised."""
        raise NotImplementedError

    def operands(self, s: int) -> List:
        """Set ``s`` as the program was handed it, in task order."""
        return self.sets[s]

    def bound_s(self, s: int) -> float:
        return work.bound_s(self.works[s])

    def flops_s(self, s: int) -> float:
        """Set ``s``'s operations alone at the compute peak."""
        return sum(w.flops / work.PEAK_FLOPS[w.dtype] for w in self.works[s])

    def release(self) -> None:
        """Drop the program's state before the check; a queue keeps
        none."""
