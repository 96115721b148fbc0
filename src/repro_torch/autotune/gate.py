"""Promotion gate — no candidate reaches the live store unverified.

The paper validates every SIP-optimized schedule with a massive random-input
sweep before deployment (§4.2); ``launch/verify.py`` is that sweep at CI
scale.  This module points the same sweep at a CANDIDATE schedule *before*
promotion: the always-on service may only commit a schedule into the live
:class:`~repro_torch.core.cache.ScheduleCache` if it

1. is not already quarantined for this (kernel, workload),
2. beats the incumbent's energy by a configurable margin (energies are
   analytic cost-model values, so they compare across sessions), and
3. passes the probabilistic correctness sweep built directly from the
   candidate (bypassing cache resolution — the incumbent keeps serving while
   the candidate is on trial).

A candidate that fails the sweep is quarantined in the service's
:class:`~repro_torch.tuning.state.SearchState` journal — the same
per-workload quarantine crash-safe tuning uses — so no later search ever
re-proposes or re-promotes it.

The sweep runs where the gate's ``device`` says: on the card it builds and
launches the candidate's own kernel, on the CPU its torch face.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cache import ScheduleCache
from repro_torch.core.registry import KernelSpec, Workload
from repro_torch.core.schedule import Schedule
from repro_torch.launch.verify import verify_workload
from repro_torch.tuning.state import SearchState


def incumbent_energy(cache: ScheduleCache, kernel: str,
                     signature: str) -> float | None:
    """Energy of the schedule currently serving this (kernel, signature) —
    the best passing entry — or None when the key is untuned (the default
    schedule serves)."""
    passing = [e for e in cache.entries(kernel, signature) if e.tests_passed]
    return min(e.energy for e in passing) if passing else None


@dataclasses.dataclass(frozen=True)
class GateDecision:
    """The gate's verdict on one candidate, journal-ready."""

    kernel: str
    workload: str
    signature: str
    schedule_sig: str
    promoted: bool
    reason: str                    # "promoted" | "quarantined_prior" |
    #                                "insufficient_margin" | "verify_failed"
    candidate_energy: float
    incumbent_energy: float | None = None
    samples: int = 0
    max_err: float = 0.0


class PromotionGate:
    """Safety gate between the shadow search and the live store.

    ``margin`` is the relative energy improvement a candidate must show over
    the incumbent (0.02 = at least 2% better); untuned keys have no
    incumbent, so any verified candidate promotes.  ``state`` (optional)
    persists quarantines across restarts; ``device`` is where the sweep
    runs.
    """

    def __init__(self, live: ScheduleCache, *, margin: float = 0.01,
                 samples: int = 8, seed: int = 0,
                 state: SearchState | None = None,
                 device: str = "cuda"):
        if margin < 0:
            raise ValueError(f"margin must be >= 0, got {margin}")
        if samples < 1:
            raise ValueError(f"samples must be >= 1, got {samples}")
        self.live = live
        self.margin = margin
        self.samples = samples
        self.seed = seed
        self.state = state
        self.device = device

    def _quarantine(self, kernel: str, workload: str,
                    schedule_sig: str) -> None:
        if self.state is None:
            return
        sigs = self.state.quarantine_for(kernel, workload)
        sigs.add(schedule_sig)
        self.state.save_quarantine(kernel, workload, sigs)

    def evaluate(self, spec: KernelSpec, workload: Workload,
                 signature: str, schedule: Schedule,
                 energy: float) -> GateDecision:
        """Gate one candidate; never mutates the live store (the service
        batches promoted decisions into ONE :meth:`ScheduleCache.commit`)."""
        ssig = schedule.signature()
        verdict = dict(kernel=spec.name, workload=workload.name,
                       signature=signature, schedule_sig=ssig,
                       candidate_energy=float(energy))
        # 1) a schedule already quarantined for this workload never promotes,
        #    whatever its energy claims — it crashed, timed out, or failed
        #    verification before
        if self.state is not None and \
                ssig in self.state.quarantine_for(spec.name, workload.name):
            return GateDecision(promoted=False, reason="quarantined_prior",
                                **verdict)
        # 2) energy margin vs the incumbent (analytic energies — comparable)
        inc = incumbent_energy(self.live, spec.name, signature)
        verdict["incumbent_energy"] = inc
        if inc is not None and not energy < inc * (1.0 - self.margin):
            return GateDecision(promoted=False, reason="insufficient_margin",
                                **verdict)
        # 3) the paper's pre-deployment correctness sweep, on the candidate
        #    itself (the incumbent keeps serving while this runs)
        res = verify_workload(spec, workload, samples=self.samples,
                              seed=self.seed, schedule=schedule,
                              device=self.device)
        verdict.update(samples=int(res["samples"]),
                       max_err=float(res["max_err"]))
        if not res["passed"]:
            self._quarantine(spec.name, workload.name, ssig)
            return GateDecision(promoted=False, reason="verify_failed",
                                **verdict)
        return GateDecision(promoted=True, reason="promoted", **verdict)
