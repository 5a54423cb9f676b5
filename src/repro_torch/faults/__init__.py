"""repro_torch.faults — deterministic fault injection and the typed
failure errors of the recovery paths.

The port of ``repro/faults/``: a seeded ``FaultPlan`` / ``FaultInjector``
(frame perturbation, replica kills, lease-expiry storms) and the errors
the engine and the cluster raise.
"""
from repro_torch.faults.errors import (EngineFailedError, MigrationFailedError,
                                       RequestFailedError)
from repro_torch.faults.injector import FAULT_KINDS, FaultInjector, FaultPlan

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultInjector", "EngineFailedError",
           "MigrationFailedError", "RequestFailedError"]
