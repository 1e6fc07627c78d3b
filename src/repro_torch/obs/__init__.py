"""Unified tracing + metrics for the port, copied from ``repro.obs``
(stdlib only) so the port carries no dependency on the JAX package. The
port's :data:`TRACE` and :data:`METRICS` are its own process objects,
separate from the JAX package's.

Two process singletons:

* :data:`TRACE` — ring-buffer tracer exporting Chrome trace-event JSON
  (Perfetto-loadable timelines: scheduler placements, serve requests,
  executor batches, measured cluster-lane windows).
* :data:`METRICS` — named counters/gauges/histograms with
  ``snapshot()`` / ``reset()`` / JSON export.

Both are off-by-default / free-when-idle: flip :func:`enable` to start
recording; with tracing off, instrumented code paths are bit-identical
to uninstrumented ones.

Also hosts the repo-wide progress-print helper (:func:`log` /
:func:`set_quiet`) so benchmarks and examples share one ``--quiet``
switch.
"""
from __future__ import annotations

import sys

from .trace import (  # noqa: F401
    ENABLED,
    PID_HOST,
    PID_MEASURED,
    PID_VIRTUAL,
    TRACE,
    Tracer,
    disable,
    enable,
    enabled,
    write_chrome_trace,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    METRICS,
    MetricsRegistry,
)

#: When true, :func:`log` drops its messages (benchmarks' ``--quiet``).
_QUIET = False


def set_quiet(quiet: bool = True) -> bool:
    """Suppress (or restore) :func:`log` output; returns previous state."""
    global _QUIET
    prev = _QUIET
    _QUIET = bool(quiet)
    return prev


def log(msg: str, *, file=None) -> None:
    """Progress print for benchmarks/examples. Goes to stderr by default
    so it never pollutes machine-read stdout (the bench CSV contract);
    silenced wholesale by :func:`set_quiet`."""
    if _QUIET:
        return
    print(msg, file=sys.stderr if file is None else file, flush=True)


__all__ = [
    "ENABLED", "PID_HOST", "PID_MEASURED", "PID_VIRTUAL",
    "TRACE", "Tracer", "disable", "enable", "enabled",
    "write_chrome_trace",
    "Counter", "Gauge", "Histogram", "METRICS", "MetricsRegistry",
    "log", "set_quiet",
]
