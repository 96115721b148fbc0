"""``@sip_jit`` — one-line integration (paper §4.1, Listing 2).

The paper decorates a Triton kernel; the cubin is intercepted, searched
offline, and the best test-passing cubin is loaded at deployment with zero
runtime overhead.  Here the decorated object is a *schedule-parameterized
kernel factory* (each kernel's ``ops.py``), and the cached artifact is a
:class:`~repro_torch.core.schedule.Schedule` instead of a patched binary — the
factory deterministically re-emits and rebuilds the optimized kernel from it
(on the card; on CPU tensors it runs the program's torch face).  Inputs are
drawn with numpy and handed over as tensors on the example arguments'
device.

    gemm = sip_jit(name="gemm_fused", build=build, program_for=make_program,
                   space_for=space, oracle=ref, signature_fn=sig)(...)
    gemm.tune(example_args, TuneConfig(...))   # offline
    y = gemm(x, w)                             # deployment: cached schedule
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, MutableSet, Sequence

import numpy as np
import torch

from repro_torch.core import annealing, energy as energy_mod, population, testing
from repro_torch.core.cache import LRUCache, ScheduleCache
from repro_torch.core.ir import Program
from repro_torch.core.mutation import MutationPolicy
from repro_torch.core.schedule import Schedule, SearchSpace
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class TuneConfig:
    rounds: int = 2               # §4.1: multiple offline rounds, greedy rank
    t_max: float = 1.0
    t_min: float = 0.02
    cooling: float = 1.05         # L in Alg. 1
    seed: int = 0
    energy: str = "costmodel"     # "costmodel" (analytic) | "wallclock"
    knob_prob: float = 0.0        # 0 == paper-faithful (order-only mutations)
    step_samples: int = 2         # probabilistic tests per search step (§4.2)
    final_samples: int = 64       # tests on the final best before caching
    rtol: float = 2e-2
    atol: float = 2e-2
    guided: bool = False          # beyond-paper cost-model-guided proposals
    greed: float = 0.5            # P(greedy action) when guided
    # --- population / throughput knobs (beyond-paper, core.population) ----
    chains: int = 1               # 1 == paper-faithful sequential chain
    exchange_every: int = 16      # lockstep rounds between best-state exchanges
    ladder: float = 1.5           # T_max ratio between temperature rungs
    memoize: bool = True          # share a CachedEnergy across chains+rounds
    build_cache: int = 32         # bounded LRU of built kernels per tune()
    # --- fault tolerance (crash-safe search) ------------------------------
    eval_deadline_s: float | None = None  # wall-clock cap per candidate
    #                                       evaluation; a wedged/crashing
    #                                       schedule is quarantined, not fatal

    def validate(self) -> "TuneConfig":
        """Reject configurations the search would only fail on much later
        (or, worse, silently misbehave on).  Called by ``SipKernel.tune``
        and ``TuningSession`` before any work starts."""
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.step_samples < 0:
            raise ValueError(f"step_samples must be >= 0, got "
                             f"{self.step_samples}")
        if self.chains < 1:
            raise ValueError(f"chains must be >= 1, got {self.chains}")
        if self.t_min >= self.t_max:
            raise ValueError(f"need t_min < t_max, got t_min={self.t_min} "
                             f">= t_max={self.t_max}")
        if self.ladder <= 0:
            raise ValueError(f"ladder must be > 0, got {self.ladder}")
        if self.energy not in ("costmodel", "wallclock"):
            raise ValueError(f"unknown energy {self.energy!r} "
                             f"(expected 'costmodel' or 'wallclock')")
        if self.eval_deadline_s is not None and self.eval_deadline_s <= 0:
            raise ValueError(f"eval_deadline_s must be > 0, got "
                             f"{self.eval_deadline_s}")
        return self


def check_space_compat(schedule: Schedule, space: SearchSpace, *,
                       kernel: str = "?") -> Schedule:
    """Raise unless ``schedule``'s knobs are a legal point of ``space``.

    The guard behind warm starting: a schedule recalled from history was
    tuned for SOME signature's space; seeding a different kernel/signature
    with it must fail loudly rather than search from an unrepresentable
    state (tests/test_autotune.py holds ``TuneHistory.warm_start`` to never
    producing one)."""
    if not space.contains(schedule.knobs):
        legal = {k.name: k.choices for k in space.knobs}
        raise ValueError(
            f"warm-start schedule {schedule.knobs!r} is not a point of "
            f"kernel {kernel!r}'s knob space {legal!r}")
    return schedule


def _make_policy(config: TuneConfig, space: SearchSpace,
                 program_for: Callable[[Schedule], Program]) -> MutationPolicy:
    """The proposal policy a tune run uses — guided when config.guided."""
    if config.guided:
        # lazy import: core.guided imports the repro_torch.core package
        from repro_torch.core.guided import GuidedMutationPolicy
        return GuidedMutationPolicy(space=space, program_for=program_for,
                                    knob_prob=config.knob_prob,
                                    greed=config.greed)
    return MutationPolicy(space=space, program_for=program_for,
                          knob_prob=config.knob_prob)


class SipKernel:
    """A kernel whose schedule is SIP-tunable and cache-backed."""

    def __init__(self, *, name: str,
                 build: Callable[..., Callable[..., Any]],
                 program_for: Callable[..., Program],
                 space_for: Callable[..., SearchSpace],
                 oracle: Callable[..., Any],
                 signature_fn: Callable[..., dict[str, Any]],
                 cache: ScheduleCache | None = None):
        self.name = name
        self._build = build              # build(schedule, **static) -> callable
        self._program_for = program_for  # program_for(schedule, **static) -> Program
        self._space_for = space_for      # space_for(**static) -> SearchSpace
        self.oracle = oracle
        self._signature_fn = signature_fn
        self.cache = cache if cache is not None else ScheduleCache()
        self._built: dict[tuple[str, str], Callable[..., Any]] = {}
        self._resolved: dict[str, Callable[..., Any]] = {}
        self._resolved_version = self.cache.version

    # ------------------------------------------------------------- plumbing
    def static_of(self, *args: Any) -> dict[str, Any]:
        return self._signature_fn(*args)

    @staticmethod
    def sig_str(static: dict[str, Any]) -> str:
        return json.dumps(static, sort_keys=True)

    def default_schedule(self, static: dict[str, Any]) -> Schedule:
        space = self._space_for(**static)
        return Schedule(knobs=space.default_knobs())

    def schedule_for(self, static: dict[str, Any]) -> Schedule:
        cached = self.cache.best(self.name, self.sig_str(static))
        return cached if cached is not None else self.default_schedule(static)

    def served_signatures(self) -> list[dict[str, Any]]:
        """The signatures this instance has served since its store last
        changed: the shapes a deployment dispatches, which a tune can then
        target."""
        return [json.loads(sig) for sig in self._resolved]

    # ------------------------------------------------------------ deployment
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        """Run the schedule resolved for ``args``' signature; ``kwargs``
        (runtime scalars such as flash's ``kv_len``) go to the kernel and
        are not part of the signature."""
        return self.kernel_for(self.static_of(*args))(*args, **kwargs)

    def built(self, static: dict[str, Any],
              schedule: Schedule) -> Callable[..., Any] | None:
        """The kernel this instance built for ``static`` under ``schedule``,
        or None if it never served that pair."""
        return self._built.get((self.sig_str(static), schedule.signature()))

    def kernel_for(self, static: dict[str, Any]) -> Callable[..., Any]:
        """The built kernel that serves ``static``'s signature: the cache's
        best schedule for it (the default when it has none), built once per
        (signature, schedule)."""
        sig = self.sig_str(static)
        if self._resolved_version != self.cache.version:
            # the shared store gained entries — possibly tuned through a
            # DIFFERENT instance bound to it — so drop resolution memos and
            # let schedule_for pick the new best
            self._resolved.clear()
            self._resolved_version = self.cache.version
        fn = self._resolved.get(sig)         # steady state: one dict lookup
        if fn is None:
            sched = self.schedule_for(static)
            key = (sig, sched.signature())
            fn = self._built.get(key)
            if fn is None:
                fn = self._build(sched, **static)
                self._built[key] = fn
            self._resolved[sig] = fn
        return fn

    # ---------------------------------------------------------------- tuning
    def tune(self, example_args: Sequence[Any],
             config: TuneConfig | None = None,
             verbose: bool = False, *,
             quarantine: MutableSet[str] | None = None,
             x0: Schedule | None = None
             ) -> list[annealing.AnnealResult]:
        """Run the offline search.  ``quarantine`` (optional, caller-owned)
        collects the signatures of schedules whose evaluation crashed or
        blew ``config.eval_deadline_s`` — they score FAILED and are skipped
        on re-proposal; ``TuningSession`` persists the set across resumes.

        ``x0`` warm-starts every chain from the given schedule instead of
        the space default (the autotune history's nearest-tuned-neighbor
        seam).  Its knobs must be legal points of THIS signature's search
        space — an incompatible warm start raises instead of silently
        searching the wrong space; a stale order is fine (resolution falls
        back to the program default when lengths mismatch)."""
        config = TuneConfig() if config is None else config
        config.validate()
        static = self.static_of(*example_args)
        sig = self.sig_str(static)
        space = self._space_for(**static)
        if x0 is not None:
            check_space_compat(x0, space, kernel=self.name)
        specs = [testing.InputSpec(tuple(a.shape), testing.dtype_name(a.dtype))
                 for a in example_args]
        device = next((a.device for a in example_args
                       if isinstance(a, torch.Tensor)), torch.device("cpu"))
        rng = np.random.default_rng(config.seed + 10_000)

        # programs depend only on the knobs (order is resolved against them),
        # so one IR build serves every permutation of a knob point — this is
        # hit by BOTH the mutation policy and the cost-model energy.
        programs: dict[str, Program] = {}

        def program_for(s: Schedule) -> Program:
            key = s.knob_signature()
            prog = programs.get(key)
            if prog is None:
                prog = programs[key] = self._program_for(s, **static)
            return prog

        # one built kernel per schedule, shared by the step-test
        # gate, wall-clock timing, and the final heavy test; bounded LRU so
        # a long search does not pin every compiled executable
        builds = LRUCache(maxsize=config.build_cache)

        def built(s: Schedule) -> Callable[..., Any]:
            return builds.get_or_build(
                s.signature(), lambda: self._build(s, **static))

        def step_test(s: Schedule) -> bool:
            if config.step_samples <= 0:
                return True
            try:
                rep = testing.probabilistic_test(
                    built(s), self.oracle, specs, config.step_samples, rng,
                    rtol=config.rtol, atol=config.atol, device=device)
            except energy_mod.UnassemblableSchedule:
                return False    # scores FAILED, like a failed test
            return rep.passed

        if config.energy == "costmodel":
            base = energy_mod.CostModelEnergy(program_for)
        elif config.energy == "wallclock":
            base = energy_mod.WallClockEnergy(
                build=built,
                make_args=lambda: [testing.to_tensor(sp.sample(rng), sp.dtype,
                                                     device) for sp in specs])
        else:
            raise ValueError(config.energy)
        guarded: Callable[[Schedule], float] = energy_mod.GuardedEnergy(base, step_test)
        quarantine_wrap: energy_mod.QuarantineEnergy | None = None
        if config.eval_deadline_s is not None or quarantine is not None:
            # inside the memo wrapper: a quarantined verdict (FAILED) is as
            # cacheable as any other, and quarantine skips stay O(1)
            quarantine_wrap = energy_mod.QuarantineEnergy(
                guarded, deadline_s=config.eval_deadline_s,
                quarantine=quarantine)
            guarded = quarantine_wrap
        if config.memoize:
            # shared across all chains AND rounds: revisited schedules are
            # free.  This also freezes each schedule's step-test verdict at
            # its first evaluation (legacy re-drew step_samples inputs per
            # revisit); the final `final_samples` heavy test below remains
            # the authoritative gate on anything that can reach the cache,
            # and memoize=False restores per-revisit re-testing.
            guarded = energy_mod.CachedEnergy(guarded)
        policy = _make_policy(config, space, program_for)
        if x0 is None:
            x0 = self.default_schedule(static)
        else:
            # merge over the defaults so knobs the neighbor never set keep
            # their space defaults (a PARTIAL warm start is still legal)
            knobs = dict(space.default_knobs())
            knobs.update(x0.knobs)
            x0 = dataclasses.replace(x0, knobs=knobs)

        results = []
        for r in range(config.rounds):
            if r and callable(getattr(guarded, "reset_stats", None)):
                # zero the shared energy cache's hit/miss counters so this
                # round's cache_stats (and any direct guarded.stats() read)
                # describes this round alone; the memo itself persists
                guarded.reset_stats()
            builds.reset_stats()
            builds_before = builds.stats()
            # chains==1 with seed offset r*1 reproduces the legacy sequential
            # restart (anneal(seed=config.seed+r)) bit-for-bit
            with obs_trace.span("tune.round", kernel=self.name, round=r,
                                chains=config.chains) as sp:
                pop = population.population_anneal(
                    x0, guarded, policy.propose, chains=config.chains,
                    t_max=config.t_max, t_min=config.t_min,
                    cooling=config.cooling, ladder=config.ladder,
                    exchange_every=config.exchange_every,
                    seed=config.seed + r * config.chains, memoize=False)
                sp["evals"] = pop.evals
                sp["best_energy"] = pop.best_energy
            res = pop.best_result()
            results.append(res)
            # final, heavier probabilistic test before the entry may be ranked
            with obs_trace.span("tune.final_test", kernel=self.name, round=r):
                try:
                    rep = testing.probabilistic_test(
                        built(res.best), self.oracle, specs,
                        config.final_samples, rng,
                        rtol=config.rtol, atol=config.atol, device=device)
                except Exception:
                    # a best candidate that crashes the heavy gate must be
                    # recorded as failing, never kill the session
                    rep = testing.TestReport(passed=False, samples_run=0)
            meta: dict[str, Any] = dict(improvement=res.improvement,
                                        evals=pop.evals, chains=config.chains,
                                        exchanges=pop.exchanges)
            if quarantine_wrap is not None:
                meta["quarantine"] = quarantine_wrap.quarantine_stats()
            # built-kernel LRU over this round, incl. the derived hit ratio
            meta["build_cache"] = energy_mod.delta_stats(builds_before,
                                                         builds.stats())
            if res.cache_stats is not None:
                meta["cache_stats"] = res.cache_stats
            self.cache.put(self.name, sig, res.best, energy=res.best_raw,
                           tests_passed=rep.passed, test_samples=rep.samples_run,
                           round_id=r, **meta)
            self._resolved.pop(sig, None)    # new entries re-resolve on call
            if verbose:
                hits = (res.cache_stats or {}).get("hits", 0)
                print(f"[sip:{self.name}] round {r}: best={res.best_raw:.3e}s "
                      f"improvement={res.improvement:+.2%} "
                      f"chains={config.chains} evals={pop.evals} "
                      f"cache_hits={hits} tests="
                      f"{'PASS' if rep.passed else 'FAIL'}({rep.samples_run})")
        return results


def sip_jit(**kwargs: Any) -> Callable[[Callable[..., Any]], SipKernel]:
    """Decorator form: ``@sip_jit(name=..., program_for=..., ...)`` over the
    kernel factory ``build(schedule, **static)`` (Listing 2 analogue)."""

    def wrap(build: Callable[..., Any]) -> SipKernel:
        return SipKernel(build=build, **kwargs)

    return wrap
