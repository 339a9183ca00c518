"""repro_torch.faults — the port's copy of the deterministic, seeded fault
injection core, plus the chaos harness that drives the port's serve
engines through seeded fault schedules.

``inject`` is the zero-dependency core (stdlib only, importable from the
kernel dispatch layer without cycles): named fault *sites* at the hot
seams, a seeded :class:`FaultPlan` of ``{site, kind, nth/probability}``
entries activated via context manager or the ``REPRO_FAULTS`` env var,
and a :func:`check` entry point that is a single global read when no plan
is active. ``chaos`` (not imported here — it pulls in the serve stack)
runs paired fault-free/faulted workloads and checks the invariants that
define correctness under failure.
"""
from .inject import (CORRUPT_SITES, KINDS, SITES, FaultPlan, FaultSpec,
                     Fired, InjectedFault, active_plan, check, deactivate,
                     install, install_from_env, parse_env)

__all__ = [
    "CORRUPT_SITES", "KINDS", "SITES", "FaultPlan", "FaultSpec", "Fired",
    "InjectedFault", "active_plan", "check", "deactivate", "install",
    "install_from_env", "parse_env",
]
