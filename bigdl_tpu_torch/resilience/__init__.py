"""Resilience for the port's serving path (the port of
``bigdl_tpu/resilience``):

- :mod:`~bigdl_tpu_torch.resilience.faults`: deterministic, seeded,
  flag-gated fault-injection sites (``BIGDL_TPU_FAULT_PLAN``) in the
  serving hot path;
- :mod:`~bigdl_tpu_torch.resilience.supervisor`: ``EngineSupervisor``,
  the watchdog that restarts a failed or wedged serving engine and
  resubmits its requests.

The training preemption guard (``preempt.py``) is ROADMAP queue A.8.
``supervisor`` is imported lazily: it imports the serving package, which
imports ``faults``.
"""

from __future__ import annotations

from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.faults import (FaultError, FaultPlan,
                                               FaultPlanError, corrupt_file,
                                               fault_point)

__all__ = ["faults", "fault_point", "corrupt_file", "FaultError",
           "FaultPlan", "FaultPlanError", "EngineSupervisor",
           "CircuitOpenError", "supervisor"]


def __getattr__(name):
    if name in ("EngineSupervisor", "CircuitOpenError", "supervisor"):
        import importlib
        sup = importlib.import_module(
            "bigdl_tpu_torch.resilience.supervisor")
        return sup if name == "supervisor" else getattr(sup, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
