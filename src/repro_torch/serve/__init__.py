"""Serving on the port: the multi-tenant ``ClusterServer`` over the
heterogeneous cluster (``repro_torch.serve.cluster``), the tenant router
of a fleet of them (``repro_torch.serve.router``) and the LM engine
(``repro_torch.serve.engine``: prefill and greedy decode)."""
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
from repro_torch.serve.engine import (
    ServeConfig,
    greedy_generate,
    make_decode_step,
    make_prefill,
)
from repro_torch.serve.router import (
    HashRing,
    Router,
    aggregate_snapshots,
    stable_hash,
)

__all__ = [
    "ServeConfig", "greedy_generate", "make_decode_step", "make_prefill",
    "ClusterServer", "Request", "RequestResult", "ServeResult",
    "ServerReport", "deploy_from_dse", "generate_trace", "load_trace",
    "save_trace", "serve_result_to_json", "trace_from_json", "trace_to_json",
    "HashRing", "Router", "aggregate_snapshots", "stable_hash",
]
