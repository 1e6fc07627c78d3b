"""Deterministic sharded data pipeline — a copy of ``repro.data.pipeline``,
which is numpy and stdlib only; batches are the same bits as ``repro``'s.

Synthetic-token and memory-mapped-file backends with per-host disjoint
sharding, deterministic resume from a step counter (checkpoint/restart
needs bit-identical batch replay), and host-side prefetch. Batches are
numpy; the caller moves them to the card.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    backend: str = "synthetic"        # synthetic | file
    path: Optional[str] = None        # token file (np.int32 flat) for 'file'
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenDataset:
    """step -> {tokens, labels} (host shard), deterministically."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.backend == "file":
            assert cfg.path, "file backend needs a path"
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
            assert self._tokens.size > cfg.seq_len + 1, "file too small"
        else:
            self._tokens = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        if self._tokens is None:
            # Counter-based generation: identical for a (seed, step, host)
            # triple regardless of how many times it is replayed.
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
            toks = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
        else:
            n = self._tokens.size - (s + 1)
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
            starts = rng.integers(0, n, (b,))
            toks = np.stack([np.asarray(self._tokens[st:st + s + 1])
                             for st in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Host-side background prefetch (overlaps data gen with device step)."""

    def __init__(self, ds: TokenDataset, start_step: int = 0):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=ds.cfg.prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put(self.ds.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
