"""repro_torch.faults — the port's copy of the seeded fault-injection core
(:mod:`~repro_torch.faults.inject`)."""
from .inject import (KINDS, SITES, FaultPlan, FaultSpec, Fired,
                     InjectedFault, check)

__all__ = ["KINDS", "SITES", "FaultPlan", "FaultSpec", "Fired",
           "InjectedFault", "check"]
