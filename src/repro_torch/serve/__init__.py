"""Serving on the port: the multi-tenant ``ClusterServer`` over the
heterogeneous cluster (``repro_torch.serve.cluster``). The JAX package's
LM engine (``serve.engine``) and router (``serve.router``) are not ported
yet."""
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

__all__ = [
    "ClusterServer", "Request", "RequestResult", "ServeResult",
    "ServerReport", "deploy_from_dse", "generate_trace", "load_trace",
    "save_trace", "serve_result_to_json", "trace_from_json", "trace_to_json",
]
