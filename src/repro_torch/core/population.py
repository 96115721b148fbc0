"""Population-based annealing / parallel tempering (beyond-paper, §6).

The paper's Alg. 1 is one sequential chain; its §6 names inefficient search
as the main limitation.  This module runs K chains in lockstep on a
*temperature ladder* — chain ``c`` cools from ``t_max * ladder**c``, so hot
chains explore while cold chains exploit — with periodic best-state
exchange: every ``exchange_every`` lockstep rounds the chain whose *current*
state is worst adopts the current state of the chain whose state is best
(elitist migration).  Acceptance stays Metropolis per chain, so single-chain
dynamics are untouched.

Guarantees:

* ``chains=1`` is bit-identical to :func:`repro_torch.core.annealing.anneal` under
  the same seed — the step logic is the shared :class:`~repro_torch.core.annealing.Chain`,
  the ladder factor is ``ladder**0 == 1`` and exchange never fires.
* Chain ``c`` uses ``seed + c``, so population runs are fully deterministic.

All chains share one energy callable; wrap it (or let ``memoize=True`` wrap
it) in :class:`~repro_torch.core.energy.CachedEnergy` so the K initial states and
every revisited/reverted schedule cost one evaluation total across the
population — the shared-state half of the throughput win measured in
the JAX package's ``benchmarks/search_throughput.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core.annealing import AnnealResult, AnnealStep, Chain
from repro_torch.core.energy import CachedEnergy, delta_stats
from repro_torch.core.schedule import Schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class PopulationResult:
    """Per-chain results plus population-level accounting."""

    chains: list[AnnealResult]
    exchanges: int                           # state migrations that occurred
    cache_stats: dict[str, float] | None = None  # aggregate across chains,
    #                                              incl. derived hit_rate

    @property
    def best_index(self) -> int:
        return min(range(len(self.chains)),
                   key=lambda i: self.chains[i].best_energy)

    def best_result(self) -> AnnealResult:
        """The winning chain's result, annotated with population cache stats."""
        res = self.chains[self.best_index]
        return dataclasses.replace(res, cache_stats=self.cache_stats)

    @property
    def best(self) -> Schedule:
        return self.chains[self.best_index].best

    @property
    def best_energy(self) -> float:
        return self.chains[self.best_index].best_energy

    @property
    def best_raw(self) -> float:
        return self.chains[self.best_index].best_raw

    @property
    def initial_raw(self) -> float:
        return self.chains[0].initial_raw

    @property
    def evals(self) -> int:
        """Total energy queries across the population (cache hits included)."""
        return sum(c.evals for c in self.chains)

    @property
    def improvement(self) -> float:
        return self.best_result().improvement


def population_anneal(
        x0: Schedule,
        energy: Callable[[Schedule], float],
        perturb: Callable[[Schedule, np.random.Generator], Schedule | None],
        *,
        chains: int = 4,
        t_max: float = 1.0,
        t_min: float = 1e-3,
        cooling: float = 1.05,
        ladder: float = 1.5,                # T_max ratio between rungs
        exchange_every: int = 16,           # lockstep rounds between migrations
        seed: int = 0,
        memoize: bool = True,
        on_step: Callable[[AnnealStep], None] | None = None) -> PopulationResult:
    """Run ``chains`` lockstep annealing chains with best-state exchange.

    ``memoize=True`` wraps ``energy`` in a shared :class:`CachedEnergy`
    unless it already exposes ``stats()`` (i.e. is one).  With a
    deterministic energy this never changes search results, only cost.
    """
    if chains < 1:
        raise ValueError(f"chains must be >= 1, got {chains}")
    if ladder < 1.0:
        raise ValueError(f"ladder must be >= 1 (rung c starts at "
                         f"t_max*ladder**c), got {ladder}")
    if memoize and not callable(getattr(energy, "stats", None)):
        energy = CachedEnergy(energy)
    stats = getattr(energy, "stats", None)
    before = stats() if callable(stats) else None

    pool = [Chain(x0, energy, perturb,
                  t_max=t_max * ladder ** c, t_min=t_min,
                  cooling=cooling, seed=seed + c, on_step=on_step,
                  label=f"chain{c}")
            for c in range(chains)]
    exchanges = 0
    lockstep = 0
    m_exchanges = obs_metrics.active_registry().counter("search.exchanges")
    while any(not c.done for c in pool):
        for c in pool:
            if not c.done:
                c.advance()
        lockstep += 1
        if chains > 1 and exchange_every > 0 and lockstep % exchange_every == 0:
            moved = _exchange(pool)
            exchanges += moved
            if moved:
                m_exchanges.inc(moved)
                obs_trace.instant("search.exchange", lockstep=lockstep,
                                  exchanges=exchanges)

    result = PopulationResult(chains=[c.result() for c in pool],
                              exchanges=exchanges)
    if before is not None:
        result.cache_stats = delta_stats(before, stats())
    return result


def _exchange(pool: list[Chain]) -> int:
    """Elitist migration: worst live chain adopts the best live state.

    Returns the number of migrations performed (0 or 1).  Only chains still
    cooling participate — a finished chain's state is frozen.  Infinite
    (test-failing) current states always lose ties, so the migration can
    rescue a chain stranded on a rejected schedule.
    """
    live = [c for c in pool if not c.done]
    if len(live) < 2:
        return 0
    lo = min(live, key=lambda c: c.e_x)
    hi = max(live, key=lambda c: c.e_x)
    if lo is hi or not math.isfinite(lo.e_x) or hi.e_x <= lo.e_x:
        return 0
    hi.adopt(lo.x, lo.e_x)
    return 1
