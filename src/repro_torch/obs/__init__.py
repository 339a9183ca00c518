"""repro_torch.obs — the port's copies of the stdlib-only tracer
(:mod:`~repro_torch.obs.trace`) and metrics registry
(:mod:`~repro_torch.obs.metrics`)."""
from . import metrics, trace
from .metrics import REGISTRY, Registry
from .trace import TRACER, Tracer, span

__all__ = ["metrics", "trace", "REGISTRY", "Registry", "TRACER", "Tracer",
           "span"]
