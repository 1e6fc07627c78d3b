"""Tenant-sharding front-end router for a fleet of serving replicas, the
port of ``repro.serve.router`` (stdlib only, copied so the port carries no
dependency on the JAX package; the same points on the ring).

One :class:`~repro_torch.serve.cluster.ClusterServer` is one serving
instance; the router is the layer above it — it pins every *tenant* to a
replica via a consistent-hash ring so a tenant's requests always queue
behind each other (per-tenant FIFO, stable fairness accounting), while
replica membership can change under it:

* :class:`HashRing` — classic consistent hashing with virtual nodes.
  Deterministic (SHA-1 of ``"node#v"`` / tenant key — no process salt, so
  in-process and subprocess workers, any two runs and both packages agree
  bit-for-bit) and *minimally disruptive*: adding a node only moves keys
  **onto** the new node, removing a node only moves **its** keys
  elsewhere — every other tenant keeps its replica.
* :class:`Router` — the fleet-facing wrapper: tenant→replica lookup,
  add/remove on scale-up/failover, and the metrics side-channel — per
  replica ``MetricsRegistry.snapshot()`` payloads shipped periodically by
  the launcher land here (:meth:`Router.record_snapshot`) and aggregate
  across the fleet (:meth:`Router.aggregate_metrics`).

Importable from every layer (the subprocess worker imports it without
touching the card).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence, Tuple


def stable_hash(key: str) -> int:
    """64-bit point on the ring for ``key`` — SHA-1 based, so identical
    across processes and Python versions (``hash()`` is salted)."""
    return int.from_bytes(hashlib.sha1(key.encode("utf-8")).digest()[:8],
                          "big")


class HashRing:
    """Consistent-hash ring with ``vnodes`` virtual points per node.

    ``lookup(key)`` walks clockwise from the key's hash to the first
    virtual point (wrapping). Membership changes move only the keys whose
    arc gained/lost an owner: on ``add(n)`` a key either keeps its node or
    moves to ``n``; on ``remove(n)`` only keys owned by ``n`` move.
    """

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[int] = []      # sorted hash points
        self._owners: List[str] = []      # node owning each point
        self._nodes: set = set()
        for n in nodes:
            self.add(n)

    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(sorted(self._nodes))

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    def add(self, node: str) -> None:
        if node in self._nodes:
            raise ValueError(f"node {node!r} already on the ring")
        self._nodes.add(node)
        for v in range(self.vnodes):
            pt = stable_hash(f"{node}#{v}")
            # Ties on identical points break by node name so insertion
            # order never changes the mapping.
            i = bisect.bisect_left(self._points, pt)
            while (i < len(self._points) and self._points[i] == pt
                   and self._owners[i] < node):
                i += 1
            self._points.insert(i, pt)
            self._owners.insert(i, node)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            raise KeyError(f"node {node!r} not on the ring")
        self._nodes.discard(node)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != node]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    def lookup(self, key: str) -> str:
        """Owning node of ``key`` (first virtual point clockwise)."""
        if not self._points:
            raise LookupError("hash ring is empty — no live replicas")
        i = bisect.bisect_right(self._points, stable_hash(key))
        if i == len(self._points):
            i = 0
        return self._owners[i]


def aggregate_snapshots(timeline: Sequence[Tuple[float, str, Dict]]
                        ) -> Dict:
    """Fleet-wide metrics view over a shipped-snapshot timeline
    (``(cycles, replica_id, snapshot)`` triples, shipping order): counters
    summed across the *latest* snapshot of every replica, gauges kept per
    replica, plus the summed live queue depth as a counter-style scalar
    (``fleet.queue_depth``). Shared by :meth:`Router.aggregate_metrics`
    and :meth:`repro_torch.launch.fleet.FleetResult.aggregate_metrics`."""
    latest: Dict[str, Dict] = {}
    for _, rid, snap in timeline:
        latest[rid] = snap
    counters: Dict[str, float] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    for rid in sorted(latest):
        snap = latest[rid]
        for name, v in snap.get("counters", {}).items():
            counters[name] = counters.get(name, 0.0) + v
        for name, v in snap.get("gauges", {}).items():
            gauges.setdefault(name, {})[rid] = v
    counters["fleet.queue_depth"] = sum(
        gauges.get("replica.queue_depth", {}).values())
    return {"counters": counters, "gauges": gauges,
            "n_replicas": len(latest)}


class Router:
    """Fleet front-end: tenant→replica sharding + metrics aggregation.

    The launcher (:class:`repro_torch.launch.fleet.FleetServer`) owns
    replica lifecycle and calls :meth:`add_replica` / :meth:`remove_replica` on
    scale-up / failover; routing decisions between those calls are pure
    ring lookups. Periodic per-replica metrics snapshots ship in via
    :meth:`record_snapshot` (virtual-time stamped) and aggregate with
    :meth:`aggregate_metrics` — counters sum across each replica's
    *latest* snapshot, gauges report per replica.
    """

    def __init__(self, replica_ids: Sequence[str] = (), vnodes: int = 64):
        self.ring = HashRing(replica_ids, vnodes=vnodes)
        #: Shipped snapshots, in shipping order: (cycles, replica_id, dict).
        self.metrics_timeline: List[Tuple[float, str, Dict]] = []

    @property
    def replicas(self) -> Tuple[str, ...]:
        return self.ring.nodes

    def route(self, tenant: str) -> str:
        """Replica serving ``tenant`` under the current membership."""
        return self.ring.lookup(tenant)

    def add_replica(self, replica_id: str) -> None:
        self.ring.add(replica_id)

    def remove_replica(self, replica_id: str) -> None:
        self.ring.remove(replica_id)

    # ----------------------------------------------------------- metrics
    def record_snapshot(self, cycles: float, replica_id: str,
                        snapshot: Dict) -> None:
        """Ship one replica ``MetricsRegistry.snapshot()`` payload to the
        router (the launcher calls this every ``snapshot_every_batches``
        admissions and at death)."""
        self.metrics_timeline.append((float(cycles), replica_id,
                                      dict(snapshot)))

    def latest_snapshots(self) -> Dict[str, Dict]:
        """Most recent shipped snapshot per replica."""
        latest: Dict[str, Dict] = {}
        for _, rid, snap in self.metrics_timeline:
            latest[rid] = snap
        return latest

    def aggregate_metrics(self) -> Dict:
        """Fleet-wide view: counters summed across the latest snapshot of
        every replica, gauges kept per replica (a summed queue depth is a
        counter-style scalar under ``counters`` too, as
        ``fleet.queue_depth``)."""
        return aggregate_snapshots(self.metrics_timeline)
