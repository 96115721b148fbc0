"""SIP core — the paper's contribution as a composable PyTorch-facing library.

Public API:
    ir.Program / ir.Instr / ir.Kind      — the mutable schedule artifact
    schedule.Schedule / SearchSpace      — candidate representation
    mutation.MutationPolicy              — §3.2 mutation policy
    energy.{CostModelEnergy,WallClockEnergy,GuardedEnergy,CachedEnergy,reward}
    annealing.anneal / multi_round       — Algorithm 1
    population.population_anneal         — K lockstep chains + best-state exchange
    testing.probabilistic_test           — §4.2 (vectorized batches)
    cache.ScheduleCache / LRUCache       — §4.1 offline store + build LRU
    jit.sip_jit / SipKernel / TuneConfig — one-line integration
    registry.{KernelSpec,Workload,sip_kernel,registry,schedule_cache}
                                         — declarative kernel registration
    costmodel                            — v5e / H100 constants + simulator
"""

from repro_torch.core.annealing import AnnealResult, AnnealStep, Chain, anneal, multi_round
from repro_torch.core.cache import CacheEntry, LRUCache, ScheduleCache
from repro_torch.core.energy import (CachedEnergy, CostModelEnergy, GuardedEnergy,
                               WallClockEnergy, reward)
from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.jit import SipKernel, TuneConfig, sip_jit
from repro_torch.core.mutation import MutationPolicy
from repro_torch.core.population import PopulationResult, population_anneal
from repro_torch.core.registry import (KernelHandle, KernelRegistry, KernelSpec,
                                 Workload, active_schedule_cache,
                                 cache_for_path, registry, schedule_cache,
                                 sip_kernel, workload_seed)
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace
from repro_torch.core.testing import FaultInjector, InputSpec, TestReport, probabilistic_test

__all__ = [
    "AnnealResult", "AnnealStep", "Chain", "anneal", "multi_round",
    "PopulationResult", "population_anneal",
    "CacheEntry", "LRUCache", "ScheduleCache",
    "CachedEnergy", "CostModelEnergy", "GuardedEnergy", "WallClockEnergy", "reward",
    "Instr", "Kind", "Program",
    "SipKernel", "TuneConfig", "sip_jit",
    "KernelHandle", "KernelRegistry", "KernelSpec", "Workload",
    "active_schedule_cache", "cache_for_path", "registry", "schedule_cache",
    "sip_kernel", "workload_seed",
    "MutationPolicy",
    "KnobSpec", "Schedule", "SearchSpace",
    "FaultInjector", "InputSpec", "TestReport", "probabilistic_test",
]
