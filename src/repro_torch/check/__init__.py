"""repro_torch.check — static feasibility, overflow and dataflow
verification of the port (port of ``repro.check``).

Everything here reasons about kernels, plans and configs WITHOUT running a
kernel: the analyses read launch arithmetic, dtype widths, quantized
weight codes, graph structure and ``ptxas``'s report of the build, and
return hard verdicts. CMSIS-NN's q7/q15 kernels are only correct because
accumulator ranges and shift amounts are proven safe ahead of time; this
package is that proof for the port, and the feasibility oracle of its
launches on an H100. The passes:

* :mod:`~repro_torch.check.footprint` — the one per-kernel Hopper launch
  model (dynamic shared bytes, threads, grid, the instantiation and its
  registers) and :func:`check_schedule`, the verdict the tuner, the
  dispatch layer and the executor share; the tune-cache audit.
* :mod:`~repro_torch.check.overflow` — int32 accumulator and
  requant-shift range analysis per quantized plan node, from the actual
  weight codes.
* :mod:`~repro_torch.check.dataflow` — an abstract interpreter over the
  plan IR: scale chaining, shapes, dtype flow, fusion legality.
* :mod:`~repro_torch.check.astlint` — an AST lint of the port's bug
  classes (``python -m repro_torch.check.astlint``).
* :mod:`~repro_torch.check.config` — serve-config checks.

:func:`validate_plan` bundles dataflow and overflow into the one call
``graph.executor.CompiledPlan`` makes at build;
``scripts/torch_check_plan.py`` runs every pass.
"""
from __future__ import annotations

from .config import (check_cnn_serve_config, check_serve_config,
                     kv_cache_bytes, paged_num_blocks)
from .dataflow import Diagnostic, check_plan
from .footprint import (Footprint, Verdict, audit_cache, check_schedule,
                        kernel_footprint, parse_cache_key, smem_budget,
                        summarize_audit)
from .overflow import (INT32_MAX, NodeBound, check_plan_overflow,
                       check_requant_shift, overflow_errors)


class CheckError(ValueError):
    """A static check failed; ``str(exc)`` lists every diagnostic."""

    def __init__(self, header: str, messages=()):
        self.messages = tuple(messages)
        body = "\n".join(f"  - {m}" for m in self.messages)
        super().__init__(f"{header}\n{body}" if self.messages else header)


def validate_plan(plan) -> None:
    """Build-time plan verification: dataflow legality and accumulator /
    shift safety from the actual weight codes. Raises :class:`CheckError`
    listing every failure; returns None when the plan is statically
    safe."""
    errors = [d.message for d in check_plan(plan) if d.level == "error"]
    errors += overflow_errors(check_plan_overflow(plan))
    if errors:
        raise CheckError(
            "plan failed static verification (repro_torch.check."
            "validate_plan; pass validate=False to bypass):", errors)


__all__ = [
    "CheckError", "Diagnostic", "Footprint", "INT32_MAX", "NodeBound",
    "Verdict", "audit_cache", "check_cnn_serve_config", "check_plan",
    "check_plan_overflow", "check_requant_shift", "check_schedule",
    "check_serve_config", "kernel_footprint", "kv_cache_bytes",
    "overflow_errors", "paged_num_blocks", "parse_cache_key",
    "smem_budget", "summarize_audit", "validate_plan",
]
