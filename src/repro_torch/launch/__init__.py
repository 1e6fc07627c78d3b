"""Launch layer of the port: device meshes (``launch.mesh``), the
multi-pod dry run (``launch.dryrun``, run as its own process) with its op
analysis (``launch.op_analysis``), the training launcher
(``launch.train``) and the multi-replica fleet launcher
(``launch.fleet``), the counterparts of ``repro.launch``'s.

The fleet's ``mesh=`` takes a
:class:`~repro_torch.core.stream_exec.StreamMesh`, not a ``DeviceMesh``.
Do not import ``launch.dryrun`` from library code: it builds the fake
production process group.
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
from repro_torch.launch.mesh import (
    axis_sizes,
    batch_axes,
    make_mesh,
    make_production_mesh,
)

__all__ = [
    "axis_sizes", "batch_axes", "make_mesh", "make_production_mesh",
    "Autoscaler", "FaultEvent", "FaultPlan", "FleetReport",
    "FleetRequestRecord", "FleetResult", "FleetServer",
    "fleet_result_to_json", "fleet_trace_events", "train",
]
