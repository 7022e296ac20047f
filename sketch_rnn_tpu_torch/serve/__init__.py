"""Port of ``sketch_rnn_tpu.serve``: continuous-batching generation, the
endpoints, the fleet, the result cache and paged tenants."""

from sketch_rnn_tpu_torch.serve.admission import (
    AdmissionClass,
    AdmissionController,
    parse_admission_classes,
    parse_tenant_slos,
)
from sketch_rnn_tpu_torch.serve.cache import ResultCache, request_fingerprint
from sketch_rnn_tpu_torch.serve.endpoints import (
    ENCODER_ENDPOINTS,
    ENDPOINTS,
    EncodeProgram,
    default_prefix_edges,
    parse_endpoint_specs,
    plan_batch,
    serve_requests,
    validate_request,
)
from sketch_rnn_tpu_torch.serve.engine import (
    Request,
    Result,
    ServeEngine,
    generate_many,
    make_chunk_step,
)
from sketch_rnn_tpu_torch.serve.fleet import ServeFleet
from sketch_rnn_tpu_torch.serve.loadgen import (
    OpenLoopLoadGen,
    Trace,
    TraceSpec,
    endpoint_mix_ids,
    make_trace,
    parse_endpoint_mix,
    parse_tenant_mix,
    poisson_arrivals,
    tenant_mix_ids,
)
from sketch_rnn_tpu_torch.serve.slo import SLO, SLOTracker, parse_slo
from sketch_rnn_tpu_torch.serve.tenants import (
    PrefixReuseIndex,
    TenantStore,
    tree_nbytes,
)

__all__ = [
    "AdmissionClass",
    "AdmissionController",
    "ENDPOINTS",
    "ENCODER_ENDPOINTS",
    "EncodeProgram",
    "OpenLoopLoadGen",
    "PrefixReuseIndex",
    "Request",
    "Result",
    "ResultCache",
    "SLO",
    "SLOTracker",
    "ServeEngine",
    "ServeFleet",
    "TenantStore",
    "Trace",
    "TraceSpec",
    "default_prefix_edges",
    "endpoint_mix_ids",
    "generate_many",
    "make_chunk_step",
    "make_trace",
    "parse_admission_classes",
    "parse_endpoint_mix",
    "parse_endpoint_specs",
    "parse_slo",
    "parse_tenant_mix",
    "parse_tenant_slos",
    "plan_batch",
    "poisson_arrivals",
    "request_fingerprint",
    "serve_requests",
    "tenant_mix_ids",
    "tree_nbytes",
    "validate_request",
]
