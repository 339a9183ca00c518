"""repro_torch.obs — the port's copies of the stdlib-only tracer
(:mod:`~repro_torch.obs.trace`: spans, request lanes, Chrome trace-event
export for Perfetto, gated by ``REPRO_TRACE``) and metrics registry
(:mod:`~repro_torch.obs.metrics`: counters, gauges, fixed-bucket
histograms, ``snapshot`` / ``to_json``)."""
from . import metrics, trace
from .metrics import REGISTRY, Registry
from .trace import TRACER, Tracer, span, traced

__all__ = ["metrics", "trace", "REGISTRY", "Registry", "TRACER", "Tracer",
           "span", "traced"]
