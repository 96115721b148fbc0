"""Feedback signal (paper §3.3).

Energy(x) is the (estimated or measured) runtime of schedule x.  The paper's
reward is ``R = (T_{i-1} - T_i) / T_0`` — positive when a mutation speeds the
kernel up.  The annealer works directly on energies; :func:`reward` is kept
for logging/parity with the paper.

Two energy backends:

* :class:`CostModelEnergy` — the two-pipe latency simulator
  (:mod:`repro_torch.core.costmodel`).  Deterministic and instant; it runs
  anywhere, so a search on the CPU follows the JAX package's trajectory.
* :class:`WallClockEnergy` — compile-and-measure on the card, the paper's
  choice: each schedule is emitted, built and timed with CUDA events.

A candidate that fails probabilistic testing gets energy = +inf (the paper's
"0 feedback signal" — the schedule can never be accepted as an improvement).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, MutableSet, Sequence

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.ir import Program
from repro_torch.core.schedule import Schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

FAILED = float("inf")


class UnassemblableSchedule(ValueError):
    """A legal order that the kernel's template cannot assemble for the card
    (its live shared-memory set exceeds what one block may use).  It scores
    :data:`FAILED`, as the paper's cuasm failure does."""


def reward(t_prev: float, t_cur: float, t0: float) -> float:
    """Paper Eq. (1): R = (T_{i-1} - T_i) / T_0."""
    if not np.isfinite(t_cur):
        return 0.0          # §4.2: failed test => 0 feedback
    return (t_prev - t_cur) / t0


@dataclasses.dataclass
class CostModelEnergy:
    """Energy from the analytic schedule simulator."""

    program_for: Callable[[Schedule], Program]
    machine: costmodel.Machine = costmodel.V5E

    def __call__(self, schedule: Schedule) -> float:
        program = self.program_for(schedule)
        return costmodel.simulate(program, schedule.resolve_order(program), self.machine)


#: back-to-back calls in one timed sample: a small kernel runs for a few µs,
#: a single call is too short to time between two events
SAMPLE_CALLS = 10
#: GPU cycles the stream sleeps per timed call before a sample starts:
#: ~0.5 ms at 2 GHz, longer than Python takes to enqueue one call
HOLD_CYCLES_PER_CALL = 1_000_000


def device_seconds(fn: Callable[..., Any], args: Sequence[Any] = (),
                   calls: int = SAMPLE_CALLS) -> float:
    """Device seconds per call of ``fn(*args)``: a pair of CUDA events
    around ``calls`` back-to-back calls, enqueued while a sleep kernel holds
    the stream.  The host's time to enqueue a call (tens of µs in Python, as
    long as a small kernel) so opens no gap between the events.  The host
    waits on the end event, not on the whole device."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES_PER_CALL * calls)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / calls


@dataclasses.dataclass
class WallClockEnergy:
    """Energy from measured execution on the card.

    ``build(schedule)`` returns a callable taking ``*args``; ``make_args()``
    returns the positional inputs as CUDA tensors.  We warm up (the first
    call compiles the schedule's kernel), then take the median of ``iters``
    samples of :func:`device_seconds`: the energy is the kernel's device
    time, not the host's time to enqueue it.  Any failure to build or run
    the schedule scores :data:`FAILED`.
    """

    build: Callable[[Schedule], Callable[..., Any]]
    make_args: Callable[[], Sequence[Any]]
    warmup: int = 2
    iters: int = 5

    def __call__(self, schedule: Schedule) -> float:
        if not torch.cuda.is_available():
            raise RuntimeError("WallClockEnergy measures on a CUDA device and "
                               "there is none; use the cost-model energy on "
                               "the CPU")
        try:
            fn = self.build(schedule)
            args = self.make_args()
            for _ in range(self.warmup):
                fn(*args)
            return float(np.median([device_seconds(fn, args)
                                    for _ in range(self.iters)]))
        except Exception:
            return FAILED   # unassemblable schedule (paper: cuasm failure)


class CachedEnergy:
    """Memoizing energy wrapper keyed on ``Schedule.signature()``.

    The SIP hot loop re-evaluates schedules constantly — Metropolis rejections
    re-propose from the same state, reverted moves regenerate earlier
    candidates, and every chain of a population search starts from the same
    x0.  Wrapping the (deterministic) energy makes all revisits free; the
    hit/miss counters are surfaced in ``AnnealResult.cache_stats`` /
    ``PopulationResult.cache_stats``.

    Share ONE instance across chains and rounds: the cache is exactly as
    deterministic as the wrapped energy.  Wrapping a stochastic energy
    freezes its first observation per schedule — for :class:`WallClockEnergy`
    a hit returns the first measurement instead of re-timing, and for
    :class:`GuardedEnergy` the probabilistic step-test verdict is drawn once
    per schedule rather than per revisit — trading noise re-sampling for
    throughput.  Callers that need a fresh verdict per visit (or a heavier
    final gate, as ``SipKernel.tune`` runs before caching) must arrange it
    outside the wrapper.
    """

    def __init__(self, energy: Callable[[Schedule], float],
                 maxsize: int | None = None):
        self.energy = energy
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._memo: dict[str, float] = {}

    def __call__(self, schedule: Schedule) -> float:
        key = schedule.signature()
        cached = self._memo.get(key)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        e = self.energy(schedule)
        if self.maxsize is not None and len(self._memo) >= self.maxsize:
            self._memo.pop(next(iter(self._memo)))   # FIFO bound
        self._memo[key] = e
        return e

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._memo)}

    def reset_stats(self) -> None:
        """Zero the hit/miss counters (the memo itself is kept).

        ``SipKernel.tune`` calls this between rounds so each round's
        ``cache_stats`` is attributable to that round alone."""
        self.hits = 0
        self.misses = 0


def delta_stats(before: dict[str, int] | None,
                after: dict[str, int]) -> dict[str, float]:
    """Per-window cache stats: counter deltas plus the derived hit ratio.

    This is what lands in ``AnnealResult.cache_stats`` — callers get
    ``hit_rate`` (0.0 when the window saw no lookups) instead of having to
    re-derive it from raw hits/misses."""
    before = before or {}
    d: dict[str, float] = {k: after[k] - before.get(k, 0) for k in after}
    total = d.get("hits", 0) + d.get("misses", 0)
    d["hit_rate"] = d.get("hits", 0) / total if total > 0 else 0.0
    return d


class QuarantineEnergy:
    """Deadline + crash quarantine around an energy callable (crash-safe
    search).

    SIP's premise is that perturbed schedules are frequently invalid — a
    candidate can fail tests (handled by :class:`GuardedEnergy`), but it can
    also CRASH the evaluator or wedge it forever (a pathological compile, an
    interpreter loop).  This wrapper makes both non-fatal: the evaluation
    runs on a worker thread under ``deadline_s``; a candidate that raises or
    exceeds the deadline is added to ``quarantine`` (by schedule signature),
    scored ``FAILED``, and never evaluated again.  A wedged worker thread is
    abandoned (daemon) and a fresh one serves the next call, so one stuck
    schedule costs one deadline, not the session.

    On CUDA the deadline bounds host-side waits only (a pathological
    compile, a Python loop).  A kernel that hangs on the card cannot be
    abandoned from a thread the way a wedged TPU call can: it holds the
    stream, and every later launch and synchronize on that device waits
    behind it until the process ends.

    ``quarantine`` may be a caller-owned set — ``TuningSession`` persists it
    in the search-state journal so a ``--resume`` skips known-bad schedules
    without re-paying their deadline.
    """

    def __init__(self, energy: Callable[[Schedule], float], *,
                 deadline_s: float | None = None,
                 quarantine: MutableSet[str] | None = None,
                 on_quarantine: Callable[[str, str], None] | None = None):
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.energy = energy
        self.deadline_s = deadline_s
        self.quarantine = quarantine if quarantine is not None else set()
        self.on_quarantine = on_quarantine
        self.timeouts = 0
        self.crashes = 0
        self.skips = 0                  # calls answered from the quarantine
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None

    def _evaluate(self, schedule: Schedule) -> float:
        if self.deadline_s is None:
            return self.energy(schedule)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sip-eval")
        fut = self._pool.submit(self.energy, schedule)
        try:
            return fut.result(timeout=self.deadline_s)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            # the worker may be wedged for good — abandon the pool (daemon
            # threads don't block exit) and lazily build a fresh one
            self._pool.shutdown(wait=False)
            self._pool = None
            raise TimeoutError(
                f"energy evaluation exceeded {self.deadline_s}s deadline")

    def __call__(self, schedule: Schedule) -> float:
        sig = schedule.signature()
        if sig in self.quarantine:
            self.skips += 1
            return FAILED
        try:
            return self._evaluate(schedule)
        except Exception as e:
            if isinstance(e, TimeoutError):
                self.timeouts += 1
            else:
                self.crashes += 1
            self.quarantine.add(sig)
            obs_metrics.active_registry().counter("ft.quarantined").inc()
            obs_trace.instant("ft.quarantine", kind=type(e).__name__,
                              detail=str(e)[:200])
            if self.on_quarantine is not None:
                self.on_quarantine(sig, f"{type(e).__name__}: {e}")
            return FAILED

    def quarantine_stats(self) -> dict[str, int]:
        return {"timeouts": self.timeouts, "crashes": self.crashes,
                "skips": self.skips, "quarantined": len(self.quarantine)}


@dataclasses.dataclass
class GuardedEnergy:
    """Energy guarded by probabilistic testing (paper §4.2).

    The test gate runs BEFORE timing: an incorrect kernel gets FAILED energy
    and thus zero reward, exactly as in the paper.
    """

    energy: Callable[[Schedule], float]
    test: Callable[[Schedule], bool]

    def __call__(self, schedule: Schedule) -> float:
        if not self.test(schedule):
            return FAILED
        return self.energy(schedule)
