"""Serving on the port: the multi-tenant ``ClusterServer`` over the
heterogeneous cluster (``repro_torch.serve.cluster``) and the tenant
router of a fleet of them (``repro_torch.serve.router``). The JAX
package's LM engine (``serve.engine``) is not ported yet."""
from repro_torch.serve.cluster import (
    ClusterServer,
    Request,
    RequestResult,
    ServeResult,
    ServerReport,
    deploy_from_dse,
    generate_trace,
    load_trace,
    save_trace,
    serve_result_to_json,
    trace_from_json,
    trace_to_json,
)
from repro_torch.serve.router import (
    HashRing,
    Router,
    aggregate_snapshots,
    stable_hash,
)

__all__ = [
    "ClusterServer", "Request", "RequestResult", "ServeResult",
    "ServerReport", "deploy_from_dse", "generate_trace", "load_trace",
    "save_trace", "serve_result_to_json", "trace_from_json", "trace_to_json",
    "HashRing", "Router", "aggregate_snapshots", "stable_hash",
]
