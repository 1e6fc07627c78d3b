"""Fault-tolerant training driver — the port of ``repro.runtime.driver``,
with JAX's control flow.

* periodic async checkpoints + automatic restart recovery,
* step-level failure containment: a transient step failure (injected in
  tests; a lost card or preemption in production) rolls back to the last
  checkpoint and replays deterministically (the data pipeline is
  counter-addressed),
* the ``max_restarts`` cap,
* straggler mitigation: a per-step wall-time watchdog records slow steps.

The watchdog reads the host clock around ``train_step``, before its
metrics are read, as JAX's does: on the card that is the time to enqueue
the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore
from repro_torch.data.pipeline import TokenDataset


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "/tmp/repro_ckpt"
    straggler_factor: float = 3.0     # step slower than factor×median = straggler
    max_restarts: int = 3


@dataclasses.dataclass
class DriverReport:
    steps_run: int
    restarts: int
    stragglers: List[int]
    final_metrics: Dict[str, float]


class TrainDriver:
    """Wraps a train_step with checkpoint/restart + watchdogs."""

    def __init__(self, cfg: DriverConfig, train_step: Callable,
                 dataset: TokenDataset, to_device: Callable[[Dict], Any]):
        self.cfg = cfg
        self.train_step = train_step
        self.dataset = dataset
        self.to_device = to_device
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir)
        self.stragglers: List[int] = []
        self._times: List[float] = []

    def _maybe_restore(self, state, shardings=None, device=None):
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return state, 0
        restored, manifest = restore(self.cfg.checkpoint_dir, state,
                                     shardings, device)
        return restored, int(manifest["step"])

    def run(self, state, fail_at: Optional[Dict[int, Exception]] = None,
            shardings=None, device=None) -> DriverReport:
        """Run to total_steps. ``fail_at`` maps step->exception for fault
        injection (tests). A restored checkpoint lands on the mesh of
        ``shardings`` (a tree of ``sharding.NamedSharding`` matching the
        state) or, without it, on ``device`` (default: the card)."""
        fail_at = dict(fail_at or {})
        restarts = 0
        metrics: Dict[str, float] = {}
        state, start = self._maybe_restore(state, shardings, device)
        step = start
        while step < self.cfg.total_steps:
            try:
                batch = self.to_device(self.dataset.batch_at(step))
                t0 = time.perf_counter()
                if step in fail_at:
                    exc = fail_at.pop(step)
                    raise exc
                state, m = self.train_step(state, batch)
                dt = time.perf_counter() - t0
                self._watch(step, dt)
                metrics = {k: float(v) for k, v in m.items()}
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(state, step)
            except Exception:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                # Recover from the last durable checkpoint and replay.
                self.ckpt.wait()
                state, step = self._maybe_restore(state, shardings, device)
        self.ckpt.save(state, step)
        self.ckpt.wait()
        return DriverReport(steps_run=step - start, restarts=restarts,
                            stragglers=self.stragglers,
                            final_metrics=metrics)

    def _watch(self, step: int, dt: float):
        self._times.append(dt)
        if len(self._times) >= 5:
            median = float(np.median(self._times[-50:]))
            if dt > self.cfg.straggler_factor * median:
                self.stragglers.append(step)
