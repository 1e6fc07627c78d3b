"""Named counters / gauges, copied from ``repro.obs.metrics`` (without its
histograms, which nothing in the port observes).

The numeric companion of :mod:`repro_torch.obs.trace`: where the tracer answers
*when* (timelines), the registry answers *how much* (totals) —
program-cache hit/miss, schedule-memo hit/miss, pipeline in-flight depth,
DSE evaluations, serve admission counts. One process
registry (:data:`METRICS`) with ``snapshot()`` / ``reset()`` / JSON
export; instruments are live objects, so hot paths bind them once at
import and pay a single attribute add per event.

Callbacks (:meth:`MetricsRegistry.register_callback`) pull external
counters — e.g. ``functools.lru_cache`` ``cache_info()`` — into every
snapshot without the owning module having to push updates.

Stdlib only, same as the tracer.
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Callable, Dict


class Counter:
    """Monotonic accumulator (resettable)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-written value (e.g. pipeline in-flight depth)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def reset(self) -> None:
        self.value = 0.0


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Instrument creation is locked; the instruments themselves are plain
    attribute updates (GIL-atomic enough for telemetry — the repo's hot
    paths are single-threaded per driver)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._callbacks: Dict[str, Callable[[], Dict]] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def register_callback(self, name: str,
                          fn: Callable[[], Dict]) -> None:
        """Pull-style source merged into every :meth:`snapshot` under
        ``derived[name]`` (e.g. an ``lru_cache`` ``cache_info()``).
        Re-registering a name replaces the callback (idempotent module
        reloads)."""
        with self._lock:
            self._callbacks[name] = fn

    def snapshot(self) -> Dict:
        with self._lock:
            counters = {n: c.value for n, c in sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            callbacks = list(self._callbacks.items())
        derived = {}
        for name, fn in sorted(callbacks):
            try:
                derived[name] = dict(fn())
            except Exception as e:  # a broken source must not kill export
                derived[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"counters": counters, "gauges": gauges, "derived": derived}

    def reset(self) -> None:
        """Zero every registered instrument (callbacks are read-only
        views of external state and are left alone)."""
        with self._lock:
            instruments = (list(self._counters.values())
                           + list(self._gauges.values()))
        for inst in instruments:
            inst.reset()

    def to_json(self) -> Dict:
        return self.snapshot()

    def export_json(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.write_text(json.dumps(self.snapshot(), indent=2, sort_keys=True)
                     + "\n")
        return p


#: The process registry every instrumentation site binds against.
METRICS = MetricsRegistry()
