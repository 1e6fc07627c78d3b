"""Multi-replica fleet launcher: N serving replicas behind a consistent-
hash router, with fault injection, failover requeue, priority admission
and queue-depth autoscaling — the port of ``repro.launch.fleet``.

The layer above :class:`~repro_torch.serve.cluster.ClusterServer`: a
*fleet* of N identical replicas, each running its own admission front-end
and incremental :class:`~repro_torch.core.scheduler.OnlineScheduler`,
with a :class:`~repro_torch.serve.router.Router` pinning tenants to
replicas via consistent hashing. Everything runs on the shared
virtual-cycles timebase: the fleet loop is a discrete-event simulation
that interleaves three event kinds in global time order — request routing
(at arrival), replica kills (absolute-time fault events) and per-replica
batch admissions — so replicas stay mutually consistent while remaining
independent scheduling engines. The loop is the JAX package's, line for
line, so both packages give the same routing, placements, times and
JSON; only the numeric execution differs (:meth:`FleetServer.serve`).

**Failover contract (exactly-once).** When a replica is killed at time
``T``, its engine is advanced to exactly ``T`` and its work partitioned
by ``finish_cycles <= T``: *retired* work (finished strictly before the
death) keeps its results and is reported from the dead replica;
everything else — in-flight placements, backlog, admitted-but-unplaced
and still-pending requests — is *lost* and requeued onto the survivors
through the ring (the dead replica is removed first, so only its tenants
move). A requeued request re-enters admission with
``route_arrival = max(original, T + failover_detect_cycles)`` and its
partial work is discarded: work is at-least-once, *results* are
exactly-once — every request appears in exactly one replica's final
accounting (enforced with a hard check).

**Fault plans.** :class:`FaultPlan` is the pluggable injection hook:
``kill`` at an absolute time, ``kill`` anchored to a replica's k-th
admission (``before_admit`` — the batch never admits; ``mid_batch`` — a
speculative :meth:`~repro_torch.core.scheduler.OnlineScheduler.fork`
lookahead aims the kill at the midpoint of that batch's execution span),
``stall`` (admissions freeze until ``at + duration``; in-flight work is
unaffected), and ``slow`` (each admission inside the window pays an
extra ``delay_cycles``). Stalls and slows only ever *delay* effective
release times, so the per-replica oracle invariant survives them:
every surviving replica's final schedule still equals
``schedule_many_kernels(config, its tasks, policy, arrivals=admitted)``.

**Priority + preemption.** Requests carry an integer ``priority`` class.
At an admission event where the engine's live queue depth is at/above
``preempt_depth``, only the batch's *top* priority class admits; lower
classes yield their slot and are deferred to the next depth-reducing
engine event (invariant: no admitted request at an event has lower
priority than a deferred one).

**Autoscaling.** :class:`Autoscaler` maps the *aggregated* live
``QueueStats.queue_depth`` across replicas to a target replica count,
monotone by construction (depth at/above ``high_water`` never scales
down; at/below ``low_water`` never scales up). Scale-up adds a fresh
replica to the ring (only ~1/N of tenants' future requests move);
scale-down only retires a fully idle replica.

**Observability.** Each replica owns a private
:class:`~repro_torch.obs.metrics.MetricsRegistry`; every
``snapshot_every_batches`` admissions (and at death) its snapshot ships
to the router (``Router.record_snapshot``) for fleet-side aggregation.
With live tracing enabled, ``serve(trace_flush_dir=...)`` rotates the
process tracer into windowed Chrome-trace files, and
:meth:`FleetResult.export_chrome_trace` writes a post-hoc fleet trace
with one pid per replica plus a router pid.

**Execution.** After the event loop, each replica's final placements run
on the card (``device=None``; ``device="cpu"`` runs the kernels' plain
versions), one replica after another: through
:func:`~repro_torch.core.hetero_matmul.execute_assignments` without a
mesh, or with ``mesh=StreamMesh(n)`` through
:func:`~repro_torch.core.hetero_matmul.execute_assignment_batches`, each
replica's batches in admission order on the one mesh the replicas share.

Workers are in-process engine objects by default; ``backend=
"subprocess"`` ships each replica's share of the trace to a real child
Python process running a :class:`ClusterServer` (fault-free,
telemetry-only: the child serves with ``execute=False`` and never touches
the card) and aggregates the JSON reports and metrics snapshots,
demonstrating the cross-process contract.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.core.scheduler import (
    ManyKernelSchedule,
    OnlineScheduler,
    SchedulingPolicy,
    TaskAssignment,
    get_policy,
)
from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.cluster import (
    ClusterServer,
    Request,
    TenantStats,
    _jain_index,
    request_operands,
    trace_to_json,
)
from repro_torch.serve.router import Router, aggregate_snapshots

#: Fleet process rows in exported Chrome traces: the router gets its own
#: pid, replica ``i`` gets ``PID_FLEET_BASE + i`` (clear of the three
#: fixed timebase pids in repro_torch.obs.trace).
PID_FLEET_ROUTER = 9
PID_FLEET_BASE = 10

_EPS = 1e-9

_MET_FLEET_BATCHES = _obs.METRICS.counter("fleet.batches")
_MET_FLEET_REQUEUED = _obs.METRICS.counter("fleet.requeued")
_MET_FLEET_PREEMPTED = _obs.METRICS.counter("fleet.preempted_deferrals")
_MET_FLEET_KILLED = _obs.METRICS.counter("fleet.replicas_killed")
_MET_FLEET_SCALE_UP = _obs.METRICS.counter("fleet.scale_ups")
_MET_FLEET_SCALE_DOWN = _obs.METRICS.counter("fleet.scale_downs")


# ------------------------------------------------------------ fault plans
_FAULT_KINDS = ("kill", "stall", "slow")
_FAULT_PHASES = ("before_admit", "mid_batch")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault on one replica.

    Triggers either at an absolute virtual time (``at_cycles``) or at the
    replica's ``at_batch``-th admission event (``phase`` picks whether the
    replica dies before admitting that batch or mid-way through its
    execution span). ``duration_cycles`` scopes ``stall``/``slow``;
    ``delay_cycles`` is the per-admission tax of ``slow``."""

    replica: int                          # replica index (replica<i>)
    kind: str                             # kill | stall | slow
    at_cycles: Optional[float] = None
    at_batch: Optional[int] = None
    phase: str = "before_admit"
    duration_cycles: float = 0.0
    delay_cycles: float = 0.0

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {_FAULT_KINDS})")
        if self.phase not in _FAULT_PHASES:
            raise ValueError(f"unknown fault phase {self.phase!r} "
                             f"(one of {_FAULT_PHASES})")
        if (self.at_cycles is None) == (self.at_batch is None):
            raise ValueError(
                "exactly one of at_cycles / at_batch must be set")
        if self.at_batch is not None and self.kind != "kill":
            raise ValueError(
                f"batch-anchored faults must be kills, got {self.kind!r}")


class FaultPlan:
    """Pluggable fault-injection hook for :class:`FleetServer`.

    A plan is anything with an ``events() -> Sequence[FaultEvent]``
    method; this default implementation is a plain container with
    constructors for the conformance suite's three canonical plans
    (die-before-admit, die-mid-batch, stall-then-recover) plus absolute
    kills and slowdowns. Plans compose: ``FaultPlan(plan_a.events() +
    plan_b.events())``."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._events = tuple(events)

    def events(self) -> Tuple[FaultEvent, ...]:
        return self._events

    @classmethod
    def kill_at(cls, replica: int, at_cycles: float) -> "FaultPlan":
        """Replica dies at an absolute virtual time."""
        return cls([FaultEvent(replica, "kill", at_cycles=float(at_cycles))])

    @classmethod
    def kill_before_admit(cls, replica: int, batch: int = 0) -> "FaultPlan":
        """Replica dies just before admitting its ``batch``-th batch."""
        return cls([FaultEvent(replica, "kill", at_batch=int(batch),
                               phase="before_admit")])

    @classmethod
    def kill_mid_batch(cls, replica: int, batch: int = 0) -> "FaultPlan":
        """Replica dies mid-way through executing its ``batch``-th
        batch (the kill time is aimed at the midpoint of the batch's
        placed span via an engine-fork lookahead)."""
        return cls([FaultEvent(replica, "kill", at_batch=int(batch),
                               phase="mid_batch")])

    @classmethod
    def stall(cls, replica: int, at_cycles: float,
              duration_cycles: float) -> "FaultPlan":
        """Admissions on the replica freeze during
        ``[at, at + duration]`` then recover; in-flight work continues."""
        return cls([FaultEvent(replica, "stall", at_cycles=float(at_cycles),
                               duration_cycles=float(duration_cycles))])

    @classmethod
    def slow(cls, replica: int, at_cycles: float, duration_cycles: float,
             delay_cycles: float) -> "FaultPlan":
        """Every admission inside ``[at, at + duration]`` pays an extra
        ``delay_cycles`` (degraded-replica model)."""
        return cls([FaultEvent(replica, "slow", at_cycles=float(at_cycles),
                               duration_cycles=float(duration_cycles),
                               delay_cycles=float(delay_cycles))])


@dataclasses.dataclass
class _PendingFault:
    ev: FaultEvent
    fired: bool = False
    applied: int = 0        # admissions a slow fault has delayed


# ------------------------------------------------------------- autoscaler
@dataclasses.dataclass(frozen=True)
class Autoscaler:
    """Queue-depth driven replica-count policy, monotone by construction.

    ``decide`` maps (aggregated live queue depth, live replica count) to
    a target count one step away at most: depth at/above ``high_water``
    asks for one more replica (never fewer — the monotonicity invariant
    pinned by tests), depth at/below ``low_water`` allows retiring one,
    anything between holds. The launcher additionally only retires fully
    idle replicas."""

    high_water: int
    low_water: int
    min_replicas: int = 1
    max_replicas: int = 8

    def __post_init__(self):
        if self.low_water >= self.high_water:
            raise ValueError(
                f"low_water ({self.low_water}) must be < high_water "
                f"({self.high_water})")
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")

    def decide(self, queue_depth: int, n_live: int) -> int:
        if queue_depth >= self.high_water:
            return max(n_live, min(n_live + 1, self.max_replicas))
        if queue_depth <= self.low_water:
            return min(n_live, max(n_live - 1, self.min_replicas))
        return n_live


# ----------------------------------------------------------- result types
@dataclasses.dataclass(frozen=True)
class FleetRequestRecord:
    """One request's fleet-level outcome: where it ran, when, and what
    the failover/preemption machinery did to it on the way."""

    request: Request
    replica: str                     # replica that completed it
    origin: str                      # replica it was first routed to
    batch_id: int                    # admission batch on `replica`
    admitted_cycles: float
    start_cycles: float
    finish_cycles: float
    requeued: int = 0                # times moved by failover
    preempted: int = 0               # times deferred by priority yield
    fault_delayed: bool = False      # admission delayed by stall/slow
    output: Optional[object] = None  # torch.Tensor when executed

    @property
    def wait_cycles(self) -> float:
        return self.start_cycles - self.request.arrival_cycles

    @property
    def turnaround_cycles(self) -> float:
        return self.finish_cycles - self.request.arrival_cycles

    @property
    def deadline_missed(self) -> bool:
        dl = self.request.deadline_cycles
        return dl is not None and self.finish_cycles > dl + _EPS

    @property
    def failover_attributed(self) -> bool:
        """SLA attribution rule: delay on a request the
        fleet moved (requeued) or held (stall/slow) is the *fleet's*
        fault, not the tenant's."""
        return self.requeued > 0 or self.fault_delayed

    def to_json(self) -> Dict:
        return {
            "request_id": self.request.request_id,
            "tenant": self.request.tenant,
            "priority": self.request.priority,
            "replica": self.replica,
            "origin": self.origin,
            "batch_id": self.batch_id,
            "admitted_cycles": self.admitted_cycles,
            "start_cycles": self.start_cycles,
            "finish_cycles": self.finish_cycles,
            "wait_cycles": self.wait_cycles,
            "turnaround_cycles": self.turnaround_cycles,
            "requeued": self.requeued,
            "preempted": self.preempted,
            "fault_delayed": self.fault_delayed,
            "deadline_missed": self.deadline_missed,
            "failover_attributed": self.failover_attributed,
        }


@dataclasses.dataclass(frozen=True)
class AdmissionEvent:
    """One admission batch on one replica (the preemption-invariant
    evidence: ``admitted``/``deferred`` carry (request_id, priority))."""

    cycles: float
    replica: str
    batch_id: int
    admitted: Tuple[Tuple[str, int], ...]
    deferred: Tuple[Tuple[str, int], ...]
    queue_depth: int                 # engine depth after the offers


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    cycles: float
    action: str                      # "up" | "down"
    replica: str
    queue_depth: int                 # aggregate depth that triggered it
    n_live: int                      # live replicas after the action


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """What a fault event actually did when (if) it fired."""

    cycles: float
    kind: str
    replica: str
    fired: bool
    n_requeued: int = 0
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class ReplicaReport:
    rid: str
    alive: bool
    draining: bool
    death_cycles: Optional[float]
    stall_cycles: float
    spawned_cycles: float
    n_requests: int
    n_batches: int
    busy_cycles: Tuple[float, ...]
    makespan_cycles: float

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Aggregate telemetry over a completed fleet serve."""

    config_name: str
    policy: str
    n_replicas_launched: int
    n_replicas_live: int
    n_requests: int
    n_batches: int
    makespan_cycles: float
    makespan_s: float
    throughput_rps: float
    stats: cm.QueueStats             # merged across replicas (PE-weighted)
    per_tenant: Tuple[TenantStats, ...]   # tenant-attributed misses only
    fairness_index: float
    energy_pj: float
    total_bytes: float
    sla_misses_total: int
    sla_misses_failover: int         # attributed to failover/stall delay
    sla_misses_tenant: int           # attributed to the tenant's own load
    requeued_requests: int
    preempted_deferrals: int
    per_replica: Tuple[ReplicaReport, ...]

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["stats"] = self.stats.to_json()
        d["per_tenant"] = [t.to_json() for t in self.per_tenant]
        d["per_replica"] = [r.to_json() for r in self.per_replica]
        return d


@dataclasses.dataclass(frozen=True)
class ReplicaOutcome:
    """Per-replica evidence for the conformance suite: the final schedule
    (survivors), retired work (dead replicas), and the admitted task list
    in engine offer order — exactly what the offline
    ``schedule_many_kernels(..., arrivals=admitted)`` oracle needs."""

    rid: str
    index: int
    alive: bool
    draining: bool
    death_cycles: Optional[float]
    stall_cycles: float
    spawned_cycles: float
    n_batches: int
    schedule: Optional[ManyKernelSchedule]
    retired: Tuple[TaskAssignment, ...]
    #: (task_index, request_id, admitted_cycles), sorted by task_index.
    admitted: Tuple[Tuple[int, str, float], ...]


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """Everything a fleet serve produced (records in submit order)."""

    records: Tuple[FleetRequestRecord, ...]
    report: FleetReport
    replicas: Tuple[ReplicaOutcome, ...]
    admission_log: Tuple[AdmissionEvent, ...]
    scale_log: Tuple[ScaleEvent, ...]
    fault_log: Tuple[FaultRecord, ...]
    #: Shipped metrics snapshots: (cycles, replica_id, snapshot dict).
    metrics_timeline: Tuple[Tuple[float, str, Dict], ...]
    #: Windowed live-trace flush files written during serve (if any).
    trace_windows: Tuple[pathlib.Path, ...] = ()

    def aggregate_metrics(self) -> Dict:
        """Fleet-wide metrics view over the shipped snapshots (latest per
        replica; counters summed — see Router.aggregate_metrics)."""
        return aggregate_snapshots(self.metrics_timeline)

    def export_chrome_trace(self, path) -> pathlib.Path:
        """Post-hoc fleet Chrome trace: one pid per replica (request
        phase rows, per-cluster placement rows, admission windows, death
        markers) plus a router pid (scale/fault instants and the
        aggregated queue-depth counter). Built from recorded results, so
        it works whether or not live tracing was on."""
        events, pnames = fleet_trace_events(self)
        return _obs.write_chrome_trace(path, events, process_names=pnames)


def fleet_result_to_json(fr: FleetResult) -> Dict:
    return {
        "report": fr.report.to_json(),
        "records": [r.to_json() for r in fr.records],
        "scale_log": [dataclasses.asdict(s) for s in fr.scale_log],
        "fault_log": [dataclasses.asdict(f) for f in fr.fault_log],
    }


# ------------------------------------------------------------- internals
@dataclasses.dataclass
class _Tracked:
    """Mutable routing envelope around one request."""

    request: Request
    route_arrival: float
    origin: str = ""
    requeued: int = 0
    preempted: int = 0
    fault_delayed: bool = False


class _Replica:
    """One in-process worker: an admission front-end state bundle around
    a private scheduling engine (the ClusterServer instance supplies the
    validated knobs and the shared depth-gate implementation)."""

    def __init__(self, rid: str, index: int, config: cm.AcceleratorConfig,
                 policy, batch_window_cycles: float,
                 max_queue_depth: Optional[int],
                 spawned_cycles: float = 0.0):
        self.rid = rid
        self.index = index
        self.server = ClusterServer(
            config, policy=policy,
            batch_window_cycles=batch_window_cycles,
            max_queue_depth=max_queue_depth)
        self.engine = OnlineScheduler(config, self.server.policy)
        self.pending: List[_Tracked] = []
        self.admitted: Dict[int, _Tracked] = {}
        self.admit_info: Dict[int, Tuple[float, int]] = {}
        self.n_batches = 0
        self.alive = True
        self.draining = False
        self.death_cycles: Optional[float] = None
        self.stall_until = 0.0
        self.stall_total = 0.0
        self.spawned_cycles = spawned_cycles
        self.retired: List[TaskAssignment] = []
        self.schedule: Optional[ManyKernelSchedule] = None
        self.metrics = MetricsRegistry()
        self.m_admitted = self.metrics.counter("replica.admitted")
        self.m_batches = self.metrics.counter("replica.batches")
        self.m_requeued_in = self.metrics.counter("replica.requeued_in")
        self.m_requeued_out = self.metrics.counter("replica.requeued_out")
        self.m_preempted = self.metrics.counter(
            "replica.preempted_deferrals")
        self.m_depth = self.metrics.gauge("replica.queue_depth")

    @property
    def accepting(self) -> bool:
        return self.alive and bool(self.pending)

    def next_admit_time(self) -> Optional[float]:
        """Nominal time of this replica's next admission event (window
        close, clamped by any active stall)."""
        if not self.accepting:
            return None
        open_t = min(t.route_arrival for t in self.pending)
        w = self.server.batch_window_cycles
        nominal = open_t + w if w > 0.0 else open_t
        return max(nominal, self.stall_until)

    def final_assignments(self) -> Tuple[TaskAssignment, ...]:
        if self.schedule is not None:
            return self.schedule.assignments
        return tuple(self.retired)

    def busy_cycles(self) -> List[float]:
        if self.schedule is not None:
            return list(self.schedule.stats.busy_cycles)
        busy = [0.0] * len(self.server.config.clusters)
        for a in self.retired:
            for pp in a.placed:
                busy[pp.partition.cluster] += pp.cycles
        return busy


# ----------------------------------------------------------------- server
class FleetServer:
    """Launcher for N serving replicas behind a consistent-hash router.

    * ``n_replicas`` in-process workers by default; ``backend=
      "subprocess"`` runs each replica as a child Python process
      (fault-free, telemetry-only — the cross-process contract demo).
    * ``batch_window_cycles`` / ``max_queue_depth`` — per-replica
      admission knobs, exactly :class:`ClusterServer`'s.
    * ``preempt_depth`` — priority preemption: at an admission event with
      the engine's live queue depth at/above this, only the batch's top
      priority class admits; lower classes defer.
    * ``fault_plan`` — pluggable injection hook (see :class:`FaultPlan`).
    * ``autoscaler`` — queue-depth driven replica count policy.
    * ``failover_detect_cycles`` — detection latency added to requeued
      requests' release times after a kill.
    * ``snapshot_every_batches`` — metrics shipping cadence (per-replica
      ``MetricsRegistry.snapshot()`` → router).

    With one replica and no faults, a fleet serve is bit-identical to a
    single :class:`ClusterServer` run of the same trace."""

    def __init__(self, config: cm.AcceleratorConfig,
                 n_replicas: int = 2,
                 policy: Union[str, SchedulingPolicy] = "optimized",
                 batch_window_cycles: float = 0.0,
                 max_queue_depth: Optional[int] = None,
                 preempt_depth: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 failover_detect_cycles: float = 0.0,
                 vnodes: int = 64,
                 snapshot_every_batches: int = 1,
                 backend: str = "inproc"):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if preempt_depth is not None and preempt_depth < 1:
            raise ValueError(
                f"preempt_depth must be >= 1 or None, got {preempt_depth}")
        if failover_detect_cycles < 0.0:
            raise ValueError("failover_detect_cycles must be >= 0")
        if snapshot_every_batches < 1:
            raise ValueError("snapshot_every_batches must be >= 1")
        if backend not in ("inproc", "subprocess"):
            raise ValueError(
                f"backend must be 'inproc' or 'subprocess', got {backend!r}")
        if backend == "subprocess" and (fault_plan is not None
                                        or autoscaler is not None):
            raise ValueError(
                "fault injection and autoscaling need the in-process "
                "backend (subprocess workers are static and fault-free)")
        self.config = config
        self.n_replicas = int(n_replicas)
        self.policy = (policy if isinstance(policy, SchedulingPolicy)
                       else get_policy(policy))
        self.batch_window_cycles = float(batch_window_cycles)
        self.max_queue_depth = max_queue_depth
        self.preempt_depth = preempt_depth
        self.fault_plan = fault_plan
        self.autoscaler = autoscaler
        self.failover_detect_cycles = float(failover_detect_cycles)
        self.vnodes = int(vnodes)
        self.snapshot_every_batches = int(snapshot_every_batches)
        self.backend = backend
        self._pending: List[Request] = []
        # validate the admission knobs once, exactly as a replica would
        ClusterServer(config, policy=self.policy,
                      batch_window_cycles=self.batch_window_cycles,
                      max_queue_depth=max_queue_depth)

    # -------------------------------------------------------- submission
    def submit(self, request: Request) -> None:
        self._pending.append(request)

    def extend(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.submit(r)

    def run_trace(self, requests: Sequence[Request], **kw) -> FleetResult:
        self.extend(requests)
        return self.serve(**kw)

    # ----------------------------------------------------------- serving
    def serve(self, operands: Optional[Dict[str, Tuple]] = None,
              execute: bool = True,
              block: int = 128,
              max_elems: int = 1 << 22,
              mesh=None,
              pipeline_depth: int = 1,
              shard_operands: bool = True,
              trace_flush_dir=None,
              trace_flush_every_batches: int = 50,
              device=None) -> FleetResult:
        """Replay every submitted request through routing, per-replica
        admission, fault injection, failover and (optionally) numeric
        execution; clears the queue.

        Execution knobs mirror :meth:`ClusterServer.serve`:
        ``device=None`` executes on the card and raises without one;
        ``device="cpu"`` runs the kernels' plain versions. The replicas
        execute one after another. With ``mesh=`` (a
        :class:`~repro_torch.core.stream_exec.StreamMesh`) each replica's
        batches run on the stream executor in admission order, every
        replica on the one mesh, ``pipeline_depth`` batches in flight;
        without one, each replica's final placements go through the
        sequential executor. ``trace_flush_dir`` (live tracing only)
        rotates the process tracer into one Chrome-trace file every
        ``trace_flush_every_batches`` fleet admissions."""
        requests = sorted(self._pending,
                          key=lambda r: (r.arrival_cycles, r.request_id))
        self._pending = []
        ids = [r.request_id for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate request_id in trace")
        if trace_flush_every_batches < 1:
            raise ValueError("trace_flush_every_batches must be >= 1")
        if self.backend == "subprocess":
            if execute or mesh is not None:
                raise ValueError(
                    "backend='subprocess' is telemetry-only: serve with "
                    "execute=False and no mesh (operands never cross the "
                    "process boundary)")
            return self._serve_subprocess(requests)
        return self._serve_inproc(
            requests, operands=operands, execute=execute, block=block,
            max_elems=max_elems, mesh=mesh, pipeline_depth=pipeline_depth,
            shard_operands=shard_operands, trace_flush_dir=trace_flush_dir,
            trace_flush_every_batches=trace_flush_every_batches,
            device=device)

    # ----------------------------------------------------- in-proc engine
    def _new_replica(self, index: int, spawned: float = 0.0) -> _Replica:
        rep = _Replica(f"replica{index}", index, self.config, self.policy,
                       self.batch_window_cycles, self.max_queue_depth,
                       spawned_cycles=spawned)
        if _trace_mod.ENABLED:
            _trace_mod.TRACE.name_process(
                PID_FLEET_BASE + index, f"{rep.rid} (modelled cycles)")
        return rep

    def _serve_inproc(self, requests, *, operands, execute, block,
                      max_elems, mesh, pipeline_depth, shard_operands,
                      trace_flush_dir, trace_flush_every_batches,
                      device) -> FleetResult:
        router = Router([f"replica{i}" for i in range(self.n_replicas)],
                        vnodes=self.vnodes)
        replicas = [self._new_replica(i) for i in range(self.n_replicas)]
        by_rid = {r.rid: r for r in replicas}
        if _trace_mod.ENABLED:
            _trace_mod.TRACE.name_process(
                PID_FLEET_ROUTER, "fleet router (modelled cycles)")

        unrouted: List[_Tracked] = [
            _Tracked(r, r.arrival_cycles) for r in requests]  # sorted
        ri = 0  # routing cursor

        plan_events = (tuple(self.fault_plan.events())
                       if self.fault_plan is not None else ())
        for ev in plan_events:
            if not (0 <= ev.replica < self.n_replicas):
                raise ValueError(
                    f"fault targets replica {ev.replica} but the fleet "
                    f"launches {self.n_replicas}")
        abs_faults: List[_PendingFault] = [
            _PendingFault(ev) for ev in plan_events
            if ev.at_cycles is not None]
        batch_faults: Dict[Tuple[int, int, str], FaultEvent] = {}
        for ev in plan_events:
            if ev.at_batch is not None:
                key = (ev.replica, ev.at_batch, ev.phase)
                if key in batch_faults:
                    raise ValueError(f"duplicate batch-anchored fault {key}")
                batch_faults[key] = ev

        admission_log: List[AdmissionEvent] = []
        scale_log: List[ScaleEvent] = []
        fault_log: List[FaultRecord] = []
        trace_windows: List[pathlib.Path] = []
        fleet_batches = 0

        def ship_snapshot(rep: _Replica, cycles: float) -> None:
            rep.m_depth.set(rep.engine.queue_depth)
            router.record_snapshot(cycles, rep.rid,
                                   rep.metrics.snapshot())

        def next_kill() -> Optional[_PendingFault]:
            live = [f for f in abs_faults
                    if not f.fired and f.ev.kind == "kill"
                    and replicas[f.ev.replica].alive]
            return min(live, key=lambda f: f.ev.at_cycles) if live else None

        def fire_kill(pf: _PendingFault, at: Optional[float] = None) -> None:
            ev = pf.ev
            pf.fired = True
            rep = replicas[ev.replica]
            T = float(ev.at_cycles if at is None else at)
            rep.engine.advance(until=T)
            by_idx = {a.task_index: a for a in rep.engine.assignments}
            retired_idx, lost = [], []
            for idx, tr in rep.admitted.items():
                a = by_idx.get(idx)
                if a is not None and a.finish_cycles <= T + _EPS:
                    retired_idx.append(idx)
                else:
                    lost.append(tr)
            rep.retired = [by_idx[i] for i in sorted(retired_idx)]
            rep.admitted = {i: rep.admitted[i] for i in sorted(retired_idx)}
            rep.admit_info = {i: rep.admit_info[i]
                              for i in sorted(retired_idx)}
            lost.extend(rep.pending)
            rep.pending = []
            rep.alive = False
            rep.death_cycles = T
            router.remove_replica(rep.rid)
            rep.m_requeued_out.inc(len(lost))
            _MET_FLEET_KILLED.inc()
            _MET_FLEET_REQUEUED.inc(len(lost))
            if lost and not router.replicas:
                raise RuntimeError(
                    f"all replicas dead at t={T:.3e} with {len(lost)} "
                    "requests outstanding — nothing left to fail over to")
            for tr in lost:
                tr.requeued += 1
                tr.route_arrival = max(
                    tr.route_arrival, T + self.failover_detect_cycles)
                target = by_rid[router.route(tr.request.tenant)]
                target.pending.append(tr)
                target.m_requeued_in.inc()
            ship_snapshot(rep, T)
            fault_log.append(FaultRecord(
                T, "kill", rep.rid, fired=True, n_requeued=len(lost),
                detail=f"{len(rep.retired)} retired"))
            if _trace_mod.ENABLED:
                _trace_mod.TRACE.instant(
                    "replica_killed", cm.cycles_to_us(T),
                    pid=PID_FLEET_ROUTER, tid="faults", cat="fleet",
                    replica=rep.rid, requeued=len(lost))

        def bind_delay_faults(rep: _Replica,
                              admit: float) -> Tuple[float, bool]:
            """Apply stall/slow faults that bind at/before this admission;
            returns the (possibly delayed) admit time."""
            delayed = False
            for pf in abs_faults:
                if pf.fired or pf.ev.replica != rep.index:
                    continue
                ev = pf.ev
                if ev.kind == "stall" and ev.at_cycles <= admit + _EPS:
                    pf.fired = True
                    rep.stall_until = max(rep.stall_until,
                                          ev.at_cycles + ev.duration_cycles)
                    rep.stall_total += ev.duration_cycles
                    fault_log.append(FaultRecord(
                        ev.at_cycles, "stall", rep.rid, fired=True,
                        detail=f"until {rep.stall_until:.3e}"))
                elif (ev.kind == "slow"
                      and ev.at_cycles - _EPS <= admit):
                    if admit <= ev.at_cycles + ev.duration_cycles + _EPS:
                        admit += ev.delay_cycles
                        pf.applied += 1
                        delayed = True
                    else:
                        pf.fired = True  # window expired
                        fault_log.append(FaultRecord(
                            ev.at_cycles, "slow", rep.rid, fired=True,
                            detail=f"expired after delaying "
                                   f"{pf.applied} admissions"))
            if rep.stall_until > admit + _EPS:
                admit = rep.stall_until
                delayed = True
            return admit, delayed

        def admit_batch(rep: _Replica) -> Optional[Tuple[_PendingFault,
                                                         float]]:
            """Run one admission event on ``rep``; returns a (kill, time)
            to fire instead when a pending fault preempts the batch."""
            nonlocal fleet_batches
            pend = sorted(rep.pending,
                          key=lambda t: (t.route_arrival,
                                         t.request.request_id))
            open_t = pend[0].route_arrival
            w = self.batch_window_cycles
            close_t = open_t + w
            batch = [t for t in pend if t.route_arrival <= close_t]
            admit = close_t if w > 0.0 else open_t
            key = (rep.index, rep.n_batches, "before_admit")
            if key in batch_faults:
                ev = batch_faults.pop(key)
                pf = _PendingFault(ev)
                abs_faults.append(pf)
                return pf, max(admit, rep.stall_until)
            admit, delayed = bind_delay_faults(rep, admit)
            # A pending kill may land inside the depth-gate's deferral,
            # so probe the gate on a fork first — commit only if no kill
            # preempts the (possibly deferred) admission time.
            has_kill = any(not f.fired and f.ev.kind == "kill"
                           and f.ev.replica == rep.index
                           for f in abs_faults)
            eng = rep.engine.fork() if has_kill else rep.engine
            eng.advance(until=admit)
            if rep.server.max_queue_depth is not None:
                rep.server._defer_for_depth(eng)
            admit = max(admit, eng.now)
            if has_kill:
                pend_kills = [f for f in abs_faults
                              if not f.fired and f.ev.kind == "kill"
                              and f.ev.replica == rep.index
                              and f.ev.at_cycles <= admit + _EPS]
                if pend_kills:
                    return (min(pend_kills, key=lambda f: f.ev.at_cycles),
                            None)
                rep.engine = eng
            eng = rep.engine

            admitted_trs, deferred_trs = list(batch), []
            if (self.preempt_depth is not None
                    and eng.queue_depth >= self.preempt_depth):
                pmax = max(t.request.priority for t in batch)
                admitted_trs = [t for t in batch
                                if t.request.priority == pmax]
                deferred_trs = [t for t in batch
                                if t.request.priority != pmax]
                if deferred_trs:
                    cand = [a.start_cycles for a in eng.assignments
                            if a.start_cycles > eng.now]
                    cand += [t for t in eng.ready if t > eng.now]
                    if cand:
                        nxt = min(cand)
                        for t in deferred_trs:
                            t.preempted += 1
                            t.route_arrival = nxt
                        rep.m_preempted.inc(len(deferred_trs))
                        _MET_FLEET_PREEMPTED.inc(len(deferred_trs))
                    else:  # nothing to wait for: admit everyone
                        admitted_trs, deferred_trs = list(batch), []

            bid = rep.n_batches
            for t in admitted_trs:
                if delayed:
                    t.fault_delayed = True
                idx = rep.engine.offer(t.request.workload, arrival=admit)
                rep.admitted[idx] = t
                rep.admit_info[idx] = (admit, bid)
            gone = {id(t) for t in admitted_trs}
            rep.pending = [t for t in rep.pending if id(t) not in gone]
            rep.n_batches += 1
            fleet_batches += 1
            rep.m_batches.inc()
            rep.m_admitted.inc(len(admitted_trs))
            _MET_FLEET_BATCHES.inc()
            admission_log.append(AdmissionEvent(
                cycles=admit, replica=rep.rid, batch_id=bid,
                admitted=tuple((t.request.request_id, t.request.priority)
                               for t in admitted_trs),
                deferred=tuple((t.request.request_id, t.request.priority)
                               for t in deferred_trs),
                queue_depth=rep.engine.queue_depth))
            if _trace_mod.ENABLED:
                _trace_mod.TRACE.complete(
                    f"window{bid}", cm.cycles_to_us(open_t),
                    cm.cycles_to_us(max(admit - open_t, 0.0)),
                    pid=PID_FLEET_BASE + rep.index, tid="admission",
                    cat="fleet", batch=bid, n_requests=len(admitted_trs),
                    deferred=len(deferred_trs))
            mkey = (rep.index, bid, "mid_batch")
            if mkey in batch_faults:
                ev = batch_faults.pop(mkey)
                look = rep.engine.fork()
                look.drain()
                idxs = {i for i, (_, b) in rep.admit_info.items()
                        if b == bid}
                spans = [a for a in look.assignments
                         if a.task_index in idxs]
                if spans:
                    lo = min(min(pp.start_cycles for pp in a.placed)
                             for a in spans)
                    hi = max(a.finish_cycles for a in spans)
                    T = max(admit + _EPS, 0.5 * (lo + hi))
                else:
                    T = admit + _EPS
                abs_faults.append(_PendingFault(dataclasses.replace(
                    ev, at_cycles=T, at_batch=None)))
            if rep.n_batches % self.snapshot_every_batches == 0:
                ship_snapshot(rep, admit)
            if (trace_flush_dir is not None and _trace_mod.ENABLED
                    and fleet_batches % trace_flush_every_batches == 0):
                out = (pathlib.Path(trace_flush_dir)
                       / f"fleet_trace_{len(trace_windows):04d}.json")
                p, _n = _trace_mod.TRACE.flush(out)
                trace_windows.append(p)
            return None

        def autoscale(now: float) -> None:
            live = [r for r in replicas if r.alive and not r.draining]
            depth = sum(r.engine.live_stats().queue_depth for r in live)
            target = self.autoscaler.decide(depth, len(live))
            if target > len(live):
                rep = self._new_replica(len(replicas), spawned=now)
                replicas.append(rep)
                by_rid[rep.rid] = rep
                router.add_replica(rep.rid)
                _MET_FLEET_SCALE_UP.inc()
                scale_log.append(ScaleEvent(now, "up", rep.rid, depth,
                                            len(live) + 1))
            elif target < len(live):
                idle = [r for r in live
                        if not r.pending and r.engine.queue_depth == 0]
                if idle:
                    rep = max(idle, key=lambda r: r.index)
                    rep.draining = True
                    router.remove_replica(rep.rid)
                    _MET_FLEET_SCALE_DOWN.inc()
                    scale_log.append(ScaleEvent(now, "down", rep.rid,
                                                depth, len(live) - 1))

        # ------------------------------------------------ the event loop
        while True:
            t_route = (unrouted[ri].route_arrival
                       if ri < len(unrouted) else None)
            pk = next_kill()
            t_kill = pk.ev.at_cycles if pk is not None else None
            t_admit, rep_next = None, None
            for rep in replicas:
                t = rep.next_admit_time()
                if t is not None and (t_admit is None or t < t_admit):
                    t_admit, rep_next = t, rep
            events = [(t, rank) for t, rank in
                      ((t_route, 0), (t_kill, 1), (t_admit, 2))
                      if t is not None]
            if not events:
                break
            _t, rank = min(events)
            if rank == 0:
                tr = unrouted[ri]
                ri += 1
                if not router.replicas:
                    raise RuntimeError(
                        f"all replicas dead at t={_t:.3e} with request "
                        f"{tr.request.request_id} arriving — nothing "
                        "left to fail over to")
                rid = router.route(tr.request.tenant)
                tr.origin = rid
                by_rid[rid].pending.append(tr)
            elif rank == 1:
                fire_kill(pk)
            else:
                res = admit_batch(rep_next)
                if res is not None:
                    pf, at = res
                    fire_kill(pf, at=at)
                elif self.autoscaler is not None:
                    autoscale(t_admit)

        for pf in abs_faults:
            if not pf.fired:
                fault_log.append(FaultRecord(
                    pf.ev.at_cycles, pf.ev.kind,
                    f"replica{pf.ev.replica}", fired=pf.applied > 0,
                    detail=(f"delayed {pf.applied} admissions"
                            if pf.applied
                            else "never bound (replica idle or dead)")))
        for (r_i, b_i, phase) in sorted(batch_faults):
            fault_log.append(FaultRecord(
                0.0, "kill", f"replica{r_i}", fired=False,
                detail=f"batch {b_i} ({phase}) never admitted"))

        for rep in replicas:
            if rep.alive:
                rep.engine.drain()
                rep.schedule = rep.engine.finish()
            ship_snapshot(rep, rep.death_cycles
                          if rep.death_cycles is not None
                          else rep.engine.now)

        if trace_flush_dir is not None and _trace_mod.ENABLED:
            out = (pathlib.Path(trace_flush_dir)
                   / f"fleet_trace_{len(trace_windows):04d}.json")
            p, n = _trace_mod.TRACE.flush(out)
            if n:
                trace_windows.append(p)

        outputs = self._execute(replicas, operands, execute, block,
                                max_elems, mesh, pipeline_depth,
                                shard_operands, device)

        records = self._collect_records(requests, replicas, outputs)
        report = self._report(requests, replicas, records, fault_log)
        outcomes = tuple(ReplicaOutcome(
            rid=rep.rid, index=rep.index, alive=rep.alive,
            draining=rep.draining, death_cycles=rep.death_cycles,
            stall_cycles=rep.stall_total, spawned_cycles=rep.spawned_cycles,
            n_batches=rep.n_batches, schedule=rep.schedule,
            retired=tuple(rep.retired),
            admitted=tuple((idx, rep.admitted[idx].request.request_id,
                            rep.admit_info[idx][0])
                           for idx in sorted(rep.admitted)),
        ) for rep in replicas)
        return FleetResult(
            records=records, report=report, replicas=outcomes,
            admission_log=tuple(admission_log),
            scale_log=tuple(scale_log), fault_log=tuple(fault_log),
            metrics_timeline=tuple(router.metrics_timeline),
            trace_windows=tuple(trace_windows))

    # ----------------------------------------------------- finalisation
    def _execute(self, replicas, operands, execute, block, max_elems,
                 mesh, pipeline_depth, shard_operands,
                 device) -> Dict[Tuple[str, int], object]:
        outputs: Dict[Tuple[str, int], object] = {}
        if not execute:
            return outputs
        from repro_torch.core.hetero_matmul import (
            _mesh_device,
            execute_assignment_batches,
            execute_assignments,
        )

        # The card unless asked for the CPU (raises without one); a
        # device= beside a mesh must be the mesh's.
        device = _mesh_device(device, mesh)
        for rep in replicas:
            if not rep.admitted:
                continue
            ops_by_index = {}
            for idx, tr in rep.admitted.items():
                r = tr.request
                if operands is not None and r.request_id in operands:
                    ops_by_index[idx] = operands[r.request_id]
                else:
                    ops_by_index[idx] = request_operands(
                        r, max_elems=max_elems)
            assignments = rep.final_assignments()
            if mesh is None:
                out = execute_assignments(
                    assignments, ops_by_index, self.config, block=block,
                    device=device)
            else:
                per_batch: Dict[int, List[TaskAssignment]] = {}
                by_idx = {a.task_index: a for a in assignments}
                for idx, (_, bid) in rep.admit_info.items():
                    per_batch.setdefault(bid, []).append(by_idx[idx])
                out = execute_assignment_batches(
                    [per_batch[b] for b in sorted(per_batch)],
                    ops_by_index, self.config, block=block, mesh=mesh,
                    pipeline_depth=pipeline_depth,
                    shard_operands=shard_operands)
            for idx, arr in out.items():
                outputs[(rep.rid, idx)] = arr
        return outputs

    def _collect_records(self, requests, replicas, outputs
                         ) -> Tuple[FleetRequestRecord, ...]:
        records: List[FleetRequestRecord] = []
        for rep in replicas:
            by_idx = {a.task_index: a for a in rep.final_assignments()}
            for idx in sorted(rep.admitted):
                tr = rep.admitted[idx]
                a = by_idx[idx]
                admit, bid = rep.admit_info[idx]
                records.append(FleetRequestRecord(
                    request=tr.request, replica=rep.rid, origin=tr.origin,
                    batch_id=bid, admitted_cycles=admit,
                    start_cycles=min(pp.start_cycles for pp in a.placed),
                    finish_cycles=a.finish_cycles,
                    requeued=tr.requeued, preempted=tr.preempted,
                    fault_delayed=tr.fault_delayed,
                    output=outputs.get((rep.rid, idx))))
        # The exactly-once contract, enforced, not assumed.
        seen = [r.request.request_id for r in records]
        if len(seen) != len(set(seen)):
            dup = sorted({x for x in seen if seen.count(x) > 1})
            raise RuntimeError(f"requests served more than once: {dup}")
        if len(seen) != len(requests):
            missing = sorted({r.request_id for r in requests} - set(seen))
            raise RuntimeError(f"requests lost by the fleet: {missing}")
        order = {r.request_id: i for i, r in enumerate(requests)}
        records.sort(key=lambda rec: order[rec.request.request_id])
        return tuple(records)

    def _report(self, requests, replicas, records,
                fault_log) -> FleetReport:
        pairs = [(self.config, rep.busy_cycles()) for rep in replicas]
        waits = [rec.wait_cycles for rec in records]
        turns = [rec.turnaround_cycles for rec in records]
        makespan = max((rec.finish_cycles for rec in records), default=0.0)
        stats = cm.merge_queue_stats(
            pairs, waits, turns, makespan,
            finish_cycles=[rec.finish_cycles for rec in records],
            deadline_cycles=[rec.request.deadline_cycles
                             for rec in records])
        per_tenant: Dict[str, List[FleetRequestRecord]] = {}
        for rec in records:
            per_tenant.setdefault(rec.request.tenant, []).append(rec)
        tenant_stats = []
        for tenant in sorted(per_tenant):
            rs = per_tenant[tenant]
            tw = [r.wait_cycles for r in rs]
            tenant_stats.append(TenantStats(
                tenant=tenant, n_requests=len(rs),
                mean_wait_cycles=sum(tw) / len(tw),
                p99_wait_cycles=cm.percentile(tw, 99.0),
                mean_turnaround_cycles=(
                    sum(r.turnaround_cycles for r in rs) / len(rs)),
                deadline_misses=sum(
                    r.deadline_missed and not r.failover_attributed
                    for r in rs)))
        misses_total = sum(r.deadline_missed for r in records)
        misses_failover = sum(r.deadline_missed and r.failover_attributed
                              for r in records)
        energy = bytes_total = 0.0
        for rep in replicas:
            if rep.schedule is not None:
                energy += rep.schedule.energy_pj
                bytes_total += rep.schedule.total_bytes
            else:
                energy += sum(a.report.energy_pj for a in rep.retired)
                bytes_total += sum(a.report.bytes_moved
                                   for a in rep.retired)
        makespan_s = cm.cycles_to_us(makespan) * 1e-6
        per_replica = tuple(ReplicaReport(
            rid=rep.rid, alive=rep.alive, draining=rep.draining,
            death_cycles=rep.death_cycles, stall_cycles=rep.stall_total,
            spawned_cycles=rep.spawned_cycles,
            n_requests=len(rep.admitted), n_batches=rep.n_batches,
            busy_cycles=tuple(rep.busy_cycles()),
            makespan_cycles=max(
                (a.finish_cycles for a in rep.final_assignments()),
                default=0.0),
        ) for rep in replicas)
        return FleetReport(
            config_name=self.config.name,
            policy=self.policy.name,
            n_replicas_launched=len(replicas),
            n_replicas_live=sum(r.alive for r in replicas),
            n_requests=len(records),
            n_batches=sum(r.n_batches for r in replicas),
            makespan_cycles=makespan,
            makespan_s=makespan_s,
            throughput_rps=(len(records) / makespan_s
                            if makespan_s > 0 else 0.0),
            stats=stats,
            per_tenant=tuple(tenant_stats),
            fairness_index=_jain_index(
                [t.mean_wait_cycles for t in tenant_stats]),
            energy_pj=energy,
            total_bytes=bytes_total,
            sla_misses_total=misses_total,
            sla_misses_failover=misses_failover,
            sla_misses_tenant=misses_total - misses_failover,
            requeued_requests=sum(r.requeued > 0 for r in records),
            preempted_deferrals=sum(r.preempted for r in records),
            per_replica=per_replica)

    # -------------------------------------------------- subprocess backend
    def _serve_subprocess(self, requests) -> FleetResult:
        router = Router([f"replica{i}" for i in range(self.n_replicas)],
                        vnodes=self.vnodes)
        shares: Dict[str, List[Request]] = {rid: []
                                            for rid in router.replicas}
        for r in requests:
            shares[router.route(r.tenant)].append(r)

        src_root = str(pathlib.Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

        records: List[FleetRequestRecord] = []
        per_replica: List[ReplicaReport] = []
        outcomes: List[ReplicaOutcome] = []
        pairs, energy, bytes_total, n_batches = [], 0.0, 0.0, 0
        by_id = {r.request_id: r for r in requests}
        for index, rid in enumerate(sorted(shares,
                                           key=lambda s: int(s[7:]))):
            share = shares[rid]
            if not share:
                per_replica.append(ReplicaReport(
                    rid, True, False, None, 0.0, 0.0, 0, 0,
                    tuple(0.0 for _ in self.config.clusters), 0.0))
                outcomes.append(ReplicaOutcome(
                    rid, index, True, False, None, 0.0, 0.0, 0, None,
                    (), ()))
                pairs.append((self.config,
                              [0.0] * len(self.config.clusters)))
                continue
            spec = {
                "config": cm.config_to_json(self.config),
                "policy": self.policy.name,
                "batch_window_cycles": self.batch_window_cycles,
                "max_queue_depth": self.max_queue_depth,
                "trace": trace_to_json(share),
            }
            proc = subprocess.run(
                [sys.executable, "-c", _WORKER_SRC],
                input=json.dumps(spec), capture_output=True, text=True,
                env=env)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"fleet worker {rid} failed "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            rep_json = out["report"]
            for res in out["results"]:
                records.append(FleetRequestRecord(
                    request=by_id[res["request_id"]], replica=rid,
                    origin=rid, batch_id=int(res["batch_id"]),
                    admitted_cycles=float(res["admitted_cycles"]),
                    start_cycles=float(res["start_cycles"]),
                    finish_cycles=float(res["finish_cycles"])))
            busy = [float(b) for b in rep_json["stats"]["busy_cycles"]]
            pairs.append((self.config, busy))
            energy += float(rep_json["energy_pj"])
            bytes_total += float(rep_json["total_bytes"])
            n_batches += int(rep_json["n_batches"])
            router.record_snapshot(float(rep_json["makespan_cycles"]),
                                   rid, out["metrics"])
            per_replica.append(ReplicaReport(
                rid, True, False, None, 0.0, 0.0,
                int(rep_json["n_requests"]), int(rep_json["n_batches"]),
                tuple(busy), float(rep_json["makespan_cycles"])))
            outcomes.append(ReplicaOutcome(
                rid, index, True, False, None, 0.0, 0.0,
                int(rep_json["n_batches"]), None, (), ()))

        seen = [r.request.request_id for r in records]
        if sorted(seen) != sorted(by_id):
            raise RuntimeError("subprocess fleet lost or duplicated "
                               "requests")
        order = {r.request_id: i for i, r in enumerate(requests)}
        records.sort(key=lambda rec: order[rec.request.request_id])
        records = tuple(records)

        waits = [rec.wait_cycles for rec in records]
        turns = [rec.turnaround_cycles for rec in records]
        makespan = max((rec.finish_cycles for rec in records), default=0.0)
        stats = cm.merge_queue_stats(
            pairs, waits, turns, makespan,
            finish_cycles=[rec.finish_cycles for rec in records],
            deadline_cycles=[rec.request.deadline_cycles
                             for rec in records])
        per_tenant: Dict[str, List[FleetRequestRecord]] = {}
        for rec in records:
            per_tenant.setdefault(rec.request.tenant, []).append(rec)
        tenant_stats = []
        for tenant in sorted(per_tenant):
            rs = per_tenant[tenant]
            tw = [r.wait_cycles for r in rs]
            tenant_stats.append(TenantStats(
                tenant=tenant, n_requests=len(rs),
                mean_wait_cycles=sum(tw) / len(tw),
                p99_wait_cycles=cm.percentile(tw, 99.0),
                mean_turnaround_cycles=(
                    sum(r.turnaround_cycles for r in rs) / len(rs)),
                deadline_misses=sum(r.deadline_missed for r in rs)))
        makespan_s = cm.cycles_to_us(makespan) * 1e-6
        misses_total = sum(r.deadline_missed for r in records)
        report = FleetReport(
            config_name=self.config.name, policy=self.policy.name,
            n_replicas_launched=self.n_replicas,
            n_replicas_live=self.n_replicas,
            n_requests=len(records), n_batches=n_batches,
            makespan_cycles=makespan, makespan_s=makespan_s,
            throughput_rps=(len(records) / makespan_s
                            if makespan_s > 0 else 0.0),
            stats=stats, per_tenant=tuple(tenant_stats),
            fairness_index=_jain_index(
                [t.mean_wait_cycles for t in tenant_stats]),
            energy_pj=energy, total_bytes=bytes_total,
            sla_misses_total=misses_total, sla_misses_failover=0,
            sla_misses_tenant=misses_total,
            requeued_requests=0, preempted_deferrals=0,
            per_replica=tuple(per_replica))
        return FleetResult(
            records=records, report=report, replicas=tuple(outcomes),
            admission_log=(), scale_log=(), fault_log=(),
            metrics_timeline=tuple(router.metrics_timeline))


#: Child source for ``backend="subprocess"``: a real ClusterServer in a
#: real child interpreter — spec JSON on stdin, serve-result JSON + the
#: child's METRICS snapshot on the last stdout line. It imports the port
#: alone and serves with ``execute=False``, so it never touches the card.
_WORKER_SRC = r"""
import json, sys
from repro_torch import obs as _obs
from repro_torch.core import costmodel as cm
from repro_torch.serve.cluster import (ClusterServer, serve_result_to_json,
                                       trace_from_json)
spec = json.load(sys.stdin)
srv = ClusterServer(cm.config_from_json(spec["config"]),
                    policy=spec["policy"],
                    batch_window_cycles=spec["batch_window_cycles"],
                    max_queue_depth=spec["max_queue_depth"])
sr = srv.run_trace(trace_from_json(spec["trace"]), execute=False)
out = serve_result_to_json(sr)
out["metrics"] = _obs.METRICS.snapshot()
print(json.dumps(out))
"""


# ------------------------------------------------------------- trace export
def fleet_trace_events(fr: FleetResult
                       ) -> Tuple[List[Dict], Dict[int, str]]:
    """Chrome trace events + process names for a completed fleet run:
    one pid per replica (request phase rows grouped by tenant,
    per-cluster placement rows, admission windows, death markers), one
    router pid (scale/fault instants, aggregated queue-depth counter)."""
    c2u = cm.cycles_to_us
    events: List[Dict] = []
    pnames: Dict[int, str] = {
        PID_FLEET_ROUTER: "fleet router (modelled cycles)"}
    idx_of = {ro.rid: ro.index for ro in fr.replicas}
    for ro in fr.replicas:
        pid = PID_FLEET_BASE + ro.index
        if ro.alive:
            status = "drained" if ro.draining else "alive"
        else:
            status = f"killed@{ro.death_cycles:.0f}cyc"
        pnames[pid] = f"{ro.rid} [{status}] (modelled cycles)"
        assignments = (ro.schedule.assignments if ro.schedule is not None
                       else ro.retired)
        for a in assignments:
            for pp in a.placed:
                events.append({
                    "ph": "X", "name": f"task{a.task_index}",
                    "ts": c2u(pp.start_cycles), "dur": c2u(pp.cycles),
                    "pid": pid, "tid": f"cluster{pp.partition.cluster}",
                    "cat": "task",
                    "args": {"task": a.task_index,
                             "cls": pp.partition.cls.value,
                             "split": a.split}})
        if not ro.alive:
            events.append({
                "ph": "i", "s": "t", "name": "replica_killed",
                "ts": c2u(ro.death_cycles), "pid": pid,
                "tid": "admission", "cat": "fleet",
                "args": {"replica": ro.rid}})
    for rec in fr.records:
        pid = PID_FLEET_BASE + idx_of[rec.replica]
        r = rec.request
        args = {
            "request_id": r.request_id, "tenant": r.tenant,
            "priority": r.priority, "batch": rec.batch_id,
            "origin": rec.origin, "requeued": rec.requeued,
            "preempted": rec.preempted,
            "fault_delayed": rec.fault_delayed,
            "deadline_missed": rec.deadline_missed,
            "failover_attributed": rec.failover_attributed,
        }
        tid = f"{r.tenant}/{r.request_id}"
        for name, t0, t1 in (
                ("admit", r.arrival_cycles, rec.admitted_cycles),
                ("queue", rec.admitted_cycles, rec.start_cycles),
                ("run", rec.start_cycles, rec.finish_cycles)):
            events.append({
                "ph": "X", "name": name, "ts": c2u(t0),
                "dur": c2u(max(t1 - t0, 0.0)), "pid": pid, "tid": tid,
                "cat": "request", "args": args})
    for ev in fr.admission_log:
        pid = PID_FLEET_BASE + idx_of[ev.replica]
        events.append({
            "ph": "X", "name": f"window{ev.batch_id}",
            "ts": c2u(ev.cycles), "dur": 0.0, "pid": pid,
            "tid": "admission", "cat": "fleet",
            "args": {"batch": ev.batch_id,
                     "admitted": len(ev.admitted),
                     "deferred": len(ev.deferred)}})
        events.append({
            "ph": "C", "name": "queue_depth", "ts": c2u(ev.cycles),
            "pid": PID_FLEET_ROUTER, "tid": "router",
            "args": {ev.replica: float(ev.queue_depth)}})
    for s in fr.scale_log:
        events.append({
            "ph": "i", "s": "t", "name": f"scale_{s.action}",
            "ts": c2u(s.cycles), "pid": PID_FLEET_ROUTER, "tid": "router",
            "cat": "fleet",
            "args": {"replica": s.replica, "queue_depth": s.queue_depth,
                     "n_live": s.n_live}})
    for f in fr.fault_log:
        if f.fired:
            events.append({
                "ph": "i", "s": "t", "name": f"fault_{f.kind}",
                "ts": c2u(f.cycles), "pid": PID_FLEET_ROUTER,
                "tid": "faults", "cat": "fleet",
                "args": {"replica": f.replica,
                         "requeued": f.n_requeued, "detail": f.detail}})
    return events, pnames
