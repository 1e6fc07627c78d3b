"""Launch layer of the port: the multi-replica fleet launcher
(``repro_torch.launch.fleet``), the port of ``repro.launch.fleet``, and
the one-card training launcher (``repro_torch.launch.train``), the
counterpart of ``repro.launch.train``.

The JAX package's ``repro.launch`` also re-exports ``make_mesh``,
``make_production_mesh``, ``axis_sizes`` and ``batch_axes`` from
``launch/mesh.py``; that module is XLA mesh tooling and is not ported
yet, so this package leaves them out. The fleet's ``mesh=`` takes a
:class:`~repro_torch.core.stream_exec.StreamMesh`.
"""
from repro_torch.launch.fleet import (
    Autoscaler,
    FaultEvent,
    FaultPlan,
    FleetReport,
    FleetRequestRecord,
    FleetResult,
    FleetServer,
    fleet_result_to_json,
    fleet_trace_events,
)
from repro_torch.launch import train

__all__ = [
    "Autoscaler", "FaultEvent", "FaultPlan", "FleetReport",
    "FleetRequestRecord", "FleetResult", "FleetServer",
    "fleet_result_to_json", "fleet_trace_events", "train",
]
