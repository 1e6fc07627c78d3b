"""Process-local tracer emitting Chrome trace-event JSON, copied from
``repro.obs.trace``.

One ring buffer of trace events for the whole process, exportable as a
``traceEvents`` JSON array that loads directly in Perfetto / chrome://
tracing. Three event phases cover everything the repro needs:

* ``ph: "X"`` — complete spans (name, ts, dur) — scheduler placements,
  per-request serve phases, batch dispatch/retire, measured submesh
  windows;
* ``ph: "i"`` — instant events — offers, policy decisions, deferrals,
  DSE incumbent improvements;
* ``ph: "C"`` — counter samples — queue depth, in-flight batches,
  cache hit/miss totals, DSE evals.

**Timebase rule (§8).** Every timestamp is microseconds, but the repo has
two clocks, so events carry a ``pid`` that names their clock and the two
never share a row:

* ``PID_VIRTUAL`` — the *modelled* timeline: scheduler cycles at
  ``hwdb.FREQ_HZ`` (1 GHz ⇒ 1000 cycles = 1 µs). Callers convert with
  their own cycles→µs factor (``repro_torch.core.costmodel.cycles_to_us``).
* ``PID_MEASURED`` — *observed* windows of each cluster's lanes
  (``stream_exec.BatchTimeline`` re-emitted; the row names keep the JAX
  package's, so both packages export the same trace).
* ``PID_HOST`` — host/driver wall-clock spans (dispatch/retire, DSE).

Wall-clock timestamps are relative to the tracer's epoch
(``perf_counter`` at construction / :meth:`Tracer.reset`);
:meth:`Tracer.ts_from_perf` maps an absolute ``perf_counter`` stamp onto
it so timelines recorded elsewhere (e.g. the pipelined executor's
``origin``-relative :class:`~repro_torch.core.stream_exec.SpanTiming`) land on
the shared timebase.

**Disabled-path guarantee (§8).** Tracing is off by default. The
module-level :data:`ENABLED` flag is checked before *any* allocation:
every recording method early-returns and :meth:`Tracer.span` hands back a
shared no-op context manager, so instrumented hot loops pay one global
load + branch per site (gated in the JAX package's
``tests/test_obs.py``). With tracing off, instrumented code paths
are bit-identical to uninstrumented ones — recording never influences a
decision.

Stdlib only — this module must stay importable from every layer
(kernels, scheduler, serving, benchmarks) without dragging torch or numpy in.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple, Union

#: Module-level fast flag — instrumentation sites check this (directly or
#: through the recording methods) before building any event payload.
ENABLED = False

#: Clock/process rows of the exported trace (§8 timebase rule).
PID_VIRTUAL = 1
PID_MEASURED = 2
PID_HOST = 3

_PROCESS_NAMES = {
    PID_VIRTUAL: "modelled (scheduler cycles)",
    PID_MEASURED: "measured (submesh wall-clock)",
    PID_HOST: "host driver (wall-clock)",
}

Tid = Union[int, str]


def enable(on: bool = True) -> bool:
    """Turn tracing on/off process-wide; returns the previous state."""
    global ENABLED
    prev = ENABLED
    ENABLED = bool(on)
    return prev


def disable() -> bool:
    return enable(False)


def enabled() -> bool:
    return ENABLED


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live wall-clock span; records a ``ph:"X"`` event on exit."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_t0")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        tr.complete(self.name, tr.ts_from_perf(self._t0),
                    (t1 - self._t0) * 1e6, pid=self.pid, tid=self.tid,
                    cat=self.cat, **self.args)
        return False


class Tracer:
    """Bounded ring buffer of Chrome trace events.

    ``capacity`` bounds memory on long serves (oldest events drop first —
    Chrome traces tolerate truncated heads). All methods are no-ops while
    the module flag :data:`ENABLED` is false. Thread-safe: the pipelined
    executor and background drivers may record concurrently.
    """

    def __init__(self, capacity: int = 200_000):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._thread_names: Dict[Tuple[int, int], str] = {}
        self._process_names: Dict[int, str] = {}

    # ------------------------------------------------------------ clocks
    def now_us(self) -> float:
        """Wall-clock µs since the tracer epoch."""
        return (time.perf_counter() - self._epoch) * 1e6

    def ts_from_perf(self, t_perf: float) -> float:
        """Map an absolute ``time.perf_counter()`` stamp to trace µs."""
        return (t_perf - self._epoch) * 1e6

    # --------------------------------------------------------- recording
    def _record(self, ev: Dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = PID_VIRTUAL, tid: Tid = 0, cat: str = "",
                 **args) -> None:
        """Record a pre-timed span (``ph:"X"``) — the entry virtual-time
        instrumentation uses (the scheduler knows start/duration in
        cycles; nothing to context-manage)."""
        if not ENABLED:
            return
        ev = {"ph": "X", "name": name, "ts": float(ts_us),
              "dur": max(float(dur_us), 0.0), "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._record(ev)

    def instant(self, name: str, ts_us: Optional[float] = None, *,
                pid: int = PID_VIRTUAL, tid: Tid = 0, cat: str = "",
                **args) -> None:
        """Record an instant event (``ph:"i"``, thread scope)."""
        if not ENABLED:
            return
        ev = {"ph": "i", "s": "t", "name": name,
              "ts": self.now_us() if ts_us is None else float(ts_us),
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._record(ev)

    def counter(self, name: str, value=None, ts_us: Optional[float] = None,
                *, pid: int = PID_VIRTUAL, tid: Tid = 0,
                **series) -> None:
        """Record a counter sample (``ph:"C"``). Either a scalar
        ``value`` (series named after the counter) or keyword series."""
        if not ENABLED:
            return
        args = dict(series)
        if value is not None:
            args[name] = float(value)
        self._record({
            "ph": "C", "name": name,
            "ts": self.now_us() if ts_us is None else float(ts_us),
            "pid": pid, "tid": tid, "args": args})

    def span(self, name: str, *, pid: int = PID_HOST, tid: Tid = 0,
             cat: str = "", **args):
        """Wall-clock span context manager; no-op singleton when
        disabled (zero allocation on the disabled path)."""
        if not ENABLED:
            return _NULL_SPAN
        return _Span(self, name, cat, pid, tid, args)

    # ---------------------------------------------------------- metadata
    def name_thread(self, pid: int, tid: int, name: str) -> None:
        """Attach a display name to an integer (pid, tid) row."""
        with self._lock:
            self._thread_names[(pid, int(tid))] = str(name)

    def name_process(self, pid: int, name: str) -> None:
        """Attach a display name to a process row — the fleet exporter
        gives every replica its own pid (one process group per replica)
        on top of the three fixed timebase pids."""
        with self._lock:
            self._process_names[int(pid)] = str(name)

    # ------------------------------------------------------------ export
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring buffer since the last reset."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def reset(self) -> None:
        """Clear events AND re-anchor the wall-clock epoch."""
        self.clear()
        self._epoch = time.perf_counter()

    def _tid_map(self, events: Iterable[Dict]) -> Dict[Tuple[int, Tid], int]:
        """Deterministic string-tid → int assignment per pid: integer
        tids pass through; string tids get consecutive ids above the
        largest integer tid of their pid, in sorted-name order (stable
        across exports of the same tracer)."""
        ints: Dict[int, int] = {}
        strs: Dict[int, set] = {}
        for ev in events:
            pid, tid = ev["pid"], ev["tid"]
            if isinstance(tid, str):
                strs.setdefault(pid, set()).add(tid)
            else:
                ints[pid] = max(ints.get(pid, 0), int(tid))
        mapping: Dict[Tuple[int, Tid], int] = {}
        for pid, names in strs.items():
            base = ints.get(pid, 0) + 1
            for i, name in enumerate(sorted(names)):
                mapping[(pid, name)] = base + i
        return mapping

    def chrome_trace(self) -> Dict:
        """The full trace as a Chrome trace-event JSON object:
        ``{"traceEvents": [...]}`` with process/thread-name metadata,
        string tids resolved to stable ints, events sorted by (pid, tid,
        ts)."""
        events = self.events()
        tid_map = self._tid_map(events)
        out: List[Dict] = []
        pnames = {**_PROCESS_NAMES, **self._process_names}
        pids = sorted({ev["pid"] for ev in events})
        for pid in pids:
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0,
                        "args": {"name": pnames.get(
                            pid, f"process {pid}")}})
            out.append({"ph": "M", "name": "process_sort_index",
                        "pid": pid, "tid": 0, "args": {"sort_index": pid}})
        named = dict(self._thread_names)
        for (pid, sname), tid in sorted(tid_map.items(),
                                        key=lambda kv: (kv[0][0], kv[1])):
            named.setdefault((pid, tid), sname)
        for (pid, tid), name in sorted(named.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": name}})
        body = []
        for ev in events:
            tid = ev["tid"]
            if isinstance(tid, str):
                ev = dict(ev)
                ev["tid"] = tid_map[(ev["pid"], tid)]
            body.append(ev)
        body.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
        return {"traceEvents": out + body, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> pathlib.Path:
        """Write the Perfetto-loadable trace JSON to ``path``."""
        p = pathlib.Path(path)
        p.write_text(json.dumps(self.chrome_trace()) + "\n")
        return p

    def flush(self, path) -> Tuple[pathlib.Path, int]:
        """Windowed flush for long-running servers :
        atomically snapshot-and-clear the buffer, then write the snapshot
        to ``path`` as a self-contained Chrome trace (row names kept; the
        wall-clock epoch is NOT re-anchored, so successive windows share
        one timebase and can be concatenated). Returns ``(path,
        n_events)`` — a zero count still writes a valid (empty) trace."""
        with self._lock:
            events = list(self._events)
            self._events.clear()
            self._dropped = 0
            tnames = dict(self._thread_names)
            pnames = dict(self._process_names)
        return (write_chrome_trace(path, events, thread_names=tnames,
                                   process_names=pnames), len(events))


#: The process tracer every instrumentation site records into.
TRACE = Tracer()


def write_chrome_trace(path, events: Iterable[Dict],
                       thread_names: Optional[Dict] = None,
                       process_names: Optional[Dict] = None) -> pathlib.Path:
    """Export a one-off event list (already in ``Tracer`` internal form,
    string tids allowed) without touching the process tracer — the
    post-hoc exporters (``ServeResult.export_chrome_trace``,
    ``FleetResult.export_chrome_trace``) build their events from recorded
    results and hand them here. ``process_names`` maps extra pids (e.g.
    one per fleet replica) to display names."""
    events = list(events)
    t = Tracer(capacity=max(len(events), 1))
    prev = enable(True)
    try:
        for ev in events:
            t._record(dict(ev))
        if thread_names:
            for (pid, tid), name in thread_names.items():
                t.name_thread(pid, tid, name)
        if process_names:
            for pid, name in process_names.items():
                t.name_process(pid, name)
        return t.export_chrome_trace(path)
    finally:
        enable(prev)
