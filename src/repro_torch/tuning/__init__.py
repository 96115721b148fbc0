"""Multi-kernel, multi-workload tuning sessions over the kernel registry."""

from repro_torch.tuning.session import SimulatedCrash, TuningSession, WorkloadRun
from repro_torch.tuning.state import SearchState, state_path_for

__all__ = ["SearchState", "SimulatedCrash", "TuningSession", "WorkloadRun",
           "state_path_for"]
