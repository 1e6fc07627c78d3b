"""Unified tracing + metrics for the port, copied from ``repro.obs``
(stdlib only) so the port carries no dependency on the JAX package. The
port's :data:`TRACE` and :data:`METRICS` are its own process objects,
separate from the JAX package's.

Two process singletons:

* :data:`TRACE` — ring-buffer tracer exporting Chrome trace-event JSON
  (Perfetto-loadable timelines: scheduler placements, serve requests,
  executor batches, measured cluster-lane windows).
* :data:`METRICS` — named counters/gauges with ``snapshot()`` /
  ``reset()`` / JSON export.

Both are off-by-default / free-when-idle: flip :func:`enable` to start
recording; with tracing off, instrumented code paths are bit-identical
to uninstrumented ones. While a ``torch.profiler`` records, the
tracer's spans are also profiler ranges, and its scalar counter samples
profiler marks (:mod:`repro_torch.obs.trace`).
"""
from __future__ import annotations

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
    METRICS,
    MetricsRegistry,
)

__all__ = [
    "ENABLED", "PID_HOST", "PID_MEASURED", "PID_VIRTUAL",
    "TRACE", "Tracer", "disable", "enable", "enabled",
    "write_chrome_trace",
    "Counter", "Gauge", "METRICS", "MetricsRegistry",
]
