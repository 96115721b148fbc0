"""repro_torch.ft — fault tolerance: detection, injection, and supervised
recovery (the port of ``repro.ft``, line for line: it imports no JAX, but
the port keeps its own copy).

* :mod:`repro_torch.ft.manager` — transport-agnostic coordinator: heartbeats,
  straggler detection, restart/elastic-reshape policy.
* :mod:`repro_torch.ft.chaos` — deterministic fault injection (seeded
  :class:`FaultPlan` + :class:`ChaosEngine`), drivable from tests and
  ``launch/train.py --chaos``.
* :mod:`repro_torch.ft.supervisor` — the loop that consumes
  ``FTManager.decide()``: restart-from-checkpoint with bounded backoff,
  elastic re-meshing, and non-finite-loss rollback with a data skip-window.
* :mod:`repro_torch.ft.errors` — the control-flow exceptions the train loop
  raises and the supervisor catches.
"""

from repro_torch.ft.chaos import ChaosEngine, Fault, FaultPlan
from repro_torch.ft.errors import (NonFiniteLossError, ReshapeRequired,
                             RestartBudgetExhausted, RestartRequired,
                             TrainFailure, WorkerKilled)
from repro_torch.ft.manager import Action, FTConfig, FTManager
from repro_torch.ft.supervisor import Supervisor, SupervisorConfig

__all__ = [
    "Action", "ChaosEngine", "Fault", "FaultPlan", "FTConfig", "FTManager",
    "NonFiniteLossError", "ReshapeRequired", "RestartBudgetExhausted",
    "RestartRequired", "Supervisor", "SupervisorConfig", "TrainFailure",
    "WorkerKilled",
]
