"""Simulated annealing for Stochastic Instruction Perturbation (paper Alg. 1).

Faithful transcription:

    1:  Initialize T_max, T_min, x
    2:  x_best <- x
    3:  T <- T_max
    4:  while T > T_min do
    5:      x' <- perturb(x)
    6:      dE = Energy(x') - Energy(x)
    7:      if dE < 0:  x <- x';  if Energy(x) < Energy(x_best): x_best <- x
    13:     elif r < exp(-dE/T):  x <- x'
    17:     T <- T * L^-1
    19: return x_best

Energies are normalized by the initial runtime T_0 so that the temperature
scale is shape-independent; the paper's reward R = (T_{i-1}-T_i)/T_0 is then
exactly -dE and is recorded per step in the history.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core.energy import delta_stats
from repro_torch.core.schedule import Schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class AnnealStep:
    step: int
    temperature: float
    energy: float          # normalized candidate energy (T_i / T_0)
    reward: float          # paper Eq. (1)
    accepted: bool
    best_energy: float


@dataclasses.dataclass
class AnnealResult:
    best: Schedule
    best_energy: float     # normalized
    best_raw: float        # seconds
    initial_raw: float     # T_0, seconds
    history: list[AnnealStep]
    evals: int
    cache_stats: dict[str, float] | None = None  # CachedEnergy hit/miss (+
    #                                              derived hit_rate), if used

    @property
    def improvement(self) -> float:
        """Fractional runtime reduction vs the unmutated schedule."""
        if not math.isfinite(self.best_raw) or self.initial_raw == 0:
            return 0.0
        return (self.initial_raw - self.best_raw) / self.initial_raw


class Chain:
    """One Alg.-1 chain, advanced one perturb/accept step at a time.

    :func:`anneal` drives a single chain to completion; population search
    (:mod:`repro_torch.core.population`) drives K of them in lockstep on a
    temperature ladder.  The step logic lives here and only here, so a
    single chain behaves bit-identically however it is driven.
    """

    def __init__(self, x0: Schedule,
                 energy: Callable[[Schedule], float],
                 perturb: Callable[[Schedule, np.random.Generator], Schedule | None],
                 *, t_max: float, t_min: float, cooling: float, seed: int,
                 on_step: Callable[[AnnealStep], None] | None = None,
                 label: str = "chain0"):
        if cooling <= 1.0:
            raise ValueError(f"cooling must be > 1 (T <- T/L each step), "
                             f"got {cooling}: the loop would never terminate")
        self.energy = energy
        self.perturb = perturb
        self.t_min = t_min
        self.cooling = cooling
        self.on_step = on_step
        self.label = label
        # search-loop telemetry: counters land in the active metrics
        # registry (scoped or process default); the per-step energy
        # trajectory goes to the active tracer, if any, as a counter track
        # per chain label (plots energy-vs-step in Perfetto)
        reg = obs_metrics.active_registry()
        self._m_steps = reg.counter("search.steps")
        self._m_accepted = reg.counter("search.accepted")
        self._m_dead = reg.counter("search.dead_steps")
        self.rng = np.random.default_rng(seed)
        t0_raw = energy(x0)
        if not math.isfinite(t0_raw) or t0_raw <= 0:
            raise ValueError("initial schedule must be runnable "
                             "(finite positive energy)")
        self.t0_raw = t0_raw
        self.x, self.e_x = x0, 1.0
        self.x_best, self.e_best, self.raw_best = x0, 1.0, t0_raw
        self.history: list[AnnealStep] = []
        self.evals = 1
        self.T = t_max
        self.step = 0

    @property
    def done(self) -> bool:
        return self.T <= self.t_min

    def _norm(self, e_raw: float) -> float:
        return e_raw / self.t0_raw if math.isfinite(e_raw) else float("inf")

    def adopt(self, x: Schedule, e_x: float) -> None:
        """Replace the current state (population exchange); best is untouched."""
        self.x, self.e_x = x, e_x

    def advance(self) -> AnnealStep | None:
        """One while-loop iteration of Alg. 1: propose, accept/reject, cool.

        Returns the recorded step, or None when no legal action existed."""
        cand = self.perturb(self.x, self.rng)
        if cand is None:                   # no legal action from x
            self._m_dead.inc()
            self.T /= self.cooling
            self.step += 1
            return None
        e_raw = self.energy(cand)
        self.evals += 1
        e_c = self._norm(e_raw)
        dE = e_c - self.e_x
        accepted = False
        if dE < 0:
            self.x, self.e_x = cand, e_c
            accepted = True
            if e_c < self.e_best:
                self.x_best, self.e_best, self.raw_best = cand, e_c, e_raw
        elif math.isfinite(dE) and self.rng.random() < math.exp(-dE / self.T):
            self.x, self.e_x = cand, e_c
            accepted = True
        rec = AnnealStep(step=self.step, temperature=self.T, energy=e_c,
                         reward=-dE if math.isfinite(dE) else 0.0,
                         accepted=accepted, best_energy=self.e_best)
        self._m_steps.inc()
        if accepted:
            self._m_accepted.inc()
        tr = obs_trace.active_tracer()
        if tr is not None:
            vals = {"best": self.e_best, "T": self.T, "step": self.step}
            if math.isfinite(e_c):
                vals["energy"] = e_c
            tr.counter(f"search.energy/{self.label}", vals)
        self.history.append(rec)
        if self.on_step is not None:
            self.on_step(rec)
        self.T /= self.cooling
        self.step += 1
        return rec

    def result(self) -> AnnealResult:
        return AnnealResult(best=self.x_best, best_energy=self.e_best,
                            best_raw=self.raw_best, initial_raw=self.t0_raw,
                            history=self.history, evals=self.evals)


def anneal(x0: Schedule,
           energy: Callable[[Schedule], float],
           perturb: Callable[[Schedule, np.random.Generator], Schedule | None],
           *,
           t_max: float = 1.0,
           t_min: float = 1e-3,
           cooling: float = 1.05,          # the paper's L:  T <- T * L^-1
           seed: int = 0,
           on_step: Callable[[AnnealStep], None] | None = None) -> AnnealResult:
    stats = getattr(energy, "stats", None)
    before = stats() if callable(stats) else None
    chain = Chain(x0, energy, perturb, t_max=t_max, t_min=t_min,
                  cooling=cooling, seed=seed, on_step=on_step)
    while not chain.done:
        chain.advance()
    res = chain.result()
    if before is not None:
        res.cache_stats = delta_stats(before, stats())
    return res


def multi_round(x0: Schedule, energy, perturb, *, rounds: int = 4,
                seed: int = 0, **kw) -> list[AnnealResult]:
    """§4.1: "SIP is expected to perform offline searches and store results
    from multiple rounds of searches" — independent restarts, greedily ranked
    by the caller (see core.cache).

    This is the paper-faithful sequential form; the tuning hot path
    (``SipKernel.tune``) now runs :func:`repro_torch.core.population.population_anneal`
    instead, which generalizes these restarts to lockstep chains with shared
    memoized energy (``chains=1`` reproduces one restart bit-for-bit)."""
    return [anneal(x0, energy, perturb, seed=seed + r, **kw) for r in range(rounds)]
