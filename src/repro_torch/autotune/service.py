"""AutotuneService — always-on tuning from live traffic (ROADMAP north star).

The offline story so far: record serving traffic, replay it into a tuning
session, restart the server on the new cache.  This module closes the loop
inside one deployment, no restart:

1. **drain** — a worker thread periodically snapshots the live
   :class:`~repro_torch.obs.recorder.WorkloadRecorder` stream (or tails
   another process's recorder JSONL) into a drift-aware
   :class:`WorkloadDistribution` — per-key traffic counts,
   staleness-decayed by a half-life so yesterday's burst does not outrank
   the shape serving right now.
2. **prioritize** — each key maps through an adapter
   (:mod:`repro_torch.autotune.adapters`) to the SIP kernel behind it;
   candidates rank by ``traffic share x energy headroom`` (incumbent
   energy over the default schedule's — untuned busy shapes first),
   decayed by how many rounds the key has already been tuned.
3. **search** — the top candidates get one incremental
   :meth:`TuningSession.run_workload` round each against a SHADOW
   :class:`ScheduleCache` — never the live store — warm-started from the
   cross-session :class:`~repro_torch.autotune.history.TuneHistory` and
   searched with its fitted guided policy.
4. **gate & promote** — every shadow winner faces the
   :class:`~repro_torch.autotune.gate.PromotionGate` (quarantine check,
   energy margin, probabilistic correctness sweep).  The cycle's survivors
   land in the live store as ONE :meth:`ScheduleCache.commit` — one
   version bump — and running engines pick them up before their next
   dispatch (``ContinuousEngine._maybe_refresh_schedules``),
   restart-free.
5. **evict** — tuned keys whose traffic share decays below a floor are
   dropped from the live store; the engine falls back to the default
   schedule and the store stops accumulating dead shapes.

On a mesh of ranks (``launch.serve --autotune --mesh N``) the service runs
on the first rank only, and its commits and evictions go to a
:class:`Staging` instead of the live store: ``launch.serve`` broadcasts
what is staged at a step boundary and every rank applies it to its own store
(:func:`apply_staged`), so every rank swaps before the same dispatch and
launches the same schedules.  Ranks in lockstep must never run different
orders.

Every decision lands in the :class:`~repro_torch.autotune.log.EventLog`
journal and the ``autotune.*`` metrics, so ``launch/obsreport.py --kind
autotune`` can reconstruct what the service did and why.

The searches and sweeps run on ``device``.  On the card a cycle's kernel
work (builds, launches, the correctness sweep, timings) goes on a CUDA
stream of the service's own and synchronises only that stream, so it
neither queues behind nor holds up the kernels of an engine serving on
another thread.  Its nvcc builds run on the worker thread; a promoted
schedule is built before it is committed, so the serving thread finds it
loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.autotune.adapters import TuneTarget
from repro_torch.autotune.gate import (GateDecision, PromotionGate,
                                      incumbent_energy)
from repro_torch.autotune.history import TuneHistory, features_of
from repro_torch.autotune.log import EventLog
from repro_torch.core import energy as energy_mod
from repro_torch.core.cache import PendingPut, ScheduleCache
from repro_torch.core.jit import TuneConfig
from repro_torch.core.registry import KernelRegistry, registry, workload_seed
from repro_torch.core.schedule import Schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.recorder import (WorkloadKey, WorkloadRecorder,
                                      tail_jsonl)
from repro_torch.tuning.session import TuningSession
from repro_torch.tuning.state import SearchState

#: the service's metric names, registered eagerly so a snapshot shows zeros
#: rather than missing keys for quiet services
_COUNTERS = ("cycles", "tuned", "promotions", "quarantines", "rejections",
             "warm_start_hits", "evictions", "errors")


def _fast_tune_config(seed: int = 0) -> TuneConfig:
    """Default per-cycle search budget: ONE short guided round.  The service
    accumulates rounds across cycles in its shadow store, so each cycle's
    search can stay cheap without capping how far a hot key ever gets."""
    return TuneConfig(rounds=1, t_max=1.0, t_min=0.1, cooling=1.2,
                      step_samples=1, final_samples=4, guided=True,
                      seed=seed)


@dataclasses.dataclass
class AutotuneConfig:
    interval_s: float = 10.0       # worker cycle period
    budget: int = 2                # workloads tuned per cycle
    margin: float = 0.01           # relative energy win required to promote
    samples: int = 8               # correctness-sweep samples per candidate
    half_life_s: float = 120.0     # traffic staleness half-life
    share_floor: float = 0.01      # evict promoted keys decaying below this
    max_rounds: int = 8            # stop re-tuning a key after this many
    seed: int = 0
    tune: TuneConfig = dataclasses.field(
        default_factory=lambda: _fast_tune_config())

    def validate(self) -> "AutotuneConfig":
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        if self.half_life_s <= 0:
            raise ValueError(f"half_life_s must be > 0, got "
                             f"{self.half_life_s}")
        if not 0 <= self.share_floor < 1:
            raise ValueError(f"share_floor must be in [0, 1), got "
                             f"{self.share_floor}")
        return self


class WorkloadDistribution:
    """Drift-aware view of the live mix: cumulative per-key counts with
    last-seen times, staleness-weighted into shares.

    ``update`` takes a CUMULATIVE snapshot (``WorkloadRecorder.
    mix_snapshot``-shaped: key -> (count, last_t)); counts only move forward,
    so re-delivery of an old snapshot can never un-count traffic.
    """

    def __init__(self, half_life_s: float = 120.0):
        self.half_life_s = half_life_s
        self._counts: dict[WorkloadKey, int] = {}
        self._last_t: dict[WorkloadKey, float] = {}

    def update(self, snapshot: Mapping[WorkloadKey, tuple[int, float]]) -> None:
        for key, (count, last_t) in snapshot.items():
            if count > self._counts.get(key, 0):
                self._counts[key] = int(count)
            if last_t > self._last_t.get(key, -1.0):
                self._last_t[key] = float(last_t)

    def weights(self, now: float) -> dict[WorkloadKey, float]:
        """count x 0.5^(staleness / half_life) per key — the raw (unshared)
        drift-aware mass."""
        out = {}
        for key, count in self._counts.items():
            age = max(0.0, now - self._last_t.get(key, 0.0))
            out[key] = count * 0.5 ** (age / self.half_life_s)
        return out

    def shares(self, now: float) -> dict[WorkloadKey, float]:
        """Normalized staleness-weighted traffic shares (sum to 1.0, or
        empty when nothing has been observed)."""
        w = self.weights(now)
        total = sum(w.values())
        if total <= 0:
            return {}
        return {k: v / total for k, v in w.items()}

    def __len__(self) -> int:
        return len(self._counts)


class Staging:
    """The live store's writes held for a step boundary: commits (a
    cycle's ``PendingPut`` batch) and drops, in the order the service made
    them.  :meth:`take` hands them over (and forgets them); every rank of
    a mesh then applies the same list (:func:`apply_staged`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: list[tuple] = []

    def commit(self, puts) -> None:
        if puts:
            with self._lock:
                self._ops.append(("commit", list(puts)))

    def drop(self, kernel_name: str, signature: str) -> None:
        with self._lock:
            self._ops.append(("drop", kernel_name, signature))

    def pending(self, kernel_name: str, signature: str) -> int:
        """Entries for one key that staged commits will add."""
        with self._lock:
            return sum(p.kernel_name == kernel_name
                       and p.signature == signature
                       for op in self._ops if op[0] == "commit"
                       for p in op[1])

    def take(self) -> list[tuple]:
        with self._lock:
            ops, self._ops = self._ops, []
        return ops


def apply_staged(store: ScheduleCache, ops) -> None:
    """Apply a :meth:`Staging.take` list to ``store``, in order: each
    commit one version bump, as the service's own commit is."""
    for op in ops or ():
        if op[0] == "commit":
            store.commit(op[1])
        else:
            store.drop(op[1], op[2])


# ------------------------------------------------------------------ sources
def recorder_source(recorder: WorkloadRecorder
                    ) -> Callable[[], tuple[dict, float]]:
    """In-process drain: the engine's own recorder, snapshotted live."""
    return lambda: (recorder.mix_snapshot(), recorder.clock)


def jsonl_source(path: str) -> Callable[[], tuple[dict, float]]:
    """Cross-process drain: tail another process's ``--record-workloads``
    JSONL (byte-offset resume, partial trailing lines left unconsumed) and
    aggregate it into the same cumulative snapshot shape.  ``now`` is the
    stream's own clock (max record t), so staleness is measured in the
    producer's timebase."""
    state = {"offset": 0, "now": 0.0}
    counts: dict[WorkloadKey, int] = {}
    last_t: dict[WorkloadKey, float] = {}

    def source() -> tuple[dict, float]:
        records, state["offset"] = tail_jsonl(path, state["offset"])
        for rec in records:
            try:
                key = WorkloadKey(kind=str(rec["kind"]),
                                  prompt_len=int(rec.get("prompt_len", 0)),
                                  batch=int(rec.get("batch", 1)),
                                  dtype=str(rec.get("dtype", "int32")))
                t = float(rec.get("t", 0.0))
            except (KeyError, TypeError, ValueError):
                continue
            counts[key] = counts.get(key, 0) + 1
            last_t[key] = max(last_t.get(key, 0.0), t)
            state["now"] = max(state["now"], t)
        return ({k: (n, last_t[k]) for k, n in counts.items()}, state["now"])

    return source


class AutotuneService:
    """The always-on background tuner (see module docstring).

    ``live`` is the deployment's ScheduleCache — the store serving engines
    resolve from; promotions commit there.  ``source`` yields
    ``(cumulative mix snapshot, now)`` (:func:`recorder_source` /
    :func:`jsonl_source`); ``target_for`` maps live keys to tunable targets
    (:func:`repro_torch.autotune.adapters.serve_targets`).

    The worker thread holds explicit references to every store — worker
    threads do not inherit the ``schedule_cache`` contextvar scope, and must
    not depend on it.  ``device`` is where searches and sweeps run (see the
    module docstring for the card's stream).  With ``staging`` the cycle's
    commit and evictions are staged there, not applied to ``live`` (a mesh
    of ranks, module docstring).
    """

    def __init__(self, live: ScheduleCache, *,
                 source: Callable[[], tuple[dict, float]],
                 target_for: Callable[[WorkloadKey], TuneTarget | None],
                 config: AutotuneConfig | None = None,
                 history: TuneHistory | None = None,
                 state: SearchState | None = None,
                 log: EventLog | None = None,
                 obs: obs_metrics.MetricsRegistry | None = None,
                 registry_: KernelRegistry | None = None,
                 device: str = "cuda",
                 staging: Staging | None = None):
        self.live = live
        self.staging = staging
        self.source = source
        self.target_for = target_for
        self.config = (config if config is not None
                       else AutotuneConfig()).validate()
        self.history = history if history is not None else TuneHistory()
        self.state = state
        self.log = log if log is not None else EventLog()
        self.obs = obs if obs is not None else obs_metrics.MetricsRegistry()
        self.registry = registry_ if registry_ is not None else registry
        self.gate = PromotionGate(live, margin=self.config.margin,
                                  samples=self.config.samples,
                                  seed=self.config.seed, state=state,
                                  device=device)
        self.dist = WorkloadDistribution(self.config.half_life_s)
        # shadow store: every search round lands here; only gated winners are
        # ever committed to `live`.  One session so kernel instances (and
        # their build caches) persist across cycles.
        self.shadow = ScheduleCache()
        self.session = TuningSession(self.shadow, self.config.tune,
                                     registry_=self.registry, state=state,
                                     device=device)
        self.device = self.session.device
        self._stream: torch.cuda.Stream | None = None
        self._c = {name: self.obs.counter(f"autotune.{name}")
                   for name in _COUNTERS}
        self._rounds: dict[WorkloadKey, int] = {}
        # key -> (kernel, signature) we promoted, for share-floor eviction
        self._promoted: dict[WorkloadKey, tuple[str, str]] = {}
        # (sig, static, space, features, default energy) per key
        self._info: dict[WorkloadKey, tuple] = {}
        self._bad_keys: set[WorkloadKey] = set()
        self._cycle = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("AutotuneService already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="autotune", daemon=True)
        self._thread.start()

    def stop(self, timeout: float | None = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        # run immediately (smoke runs should not wait a full interval for
        # their first cycle), then on the period until stopped
        while True:
            try:
                self.run_once()
            except Exception as e:  # keep the service alive; journal it
                self._c["errors"].inc()
                self.log.emit("error", error=f"{type(e).__name__}: {e}"[:500])
            if self._stop.wait(self.config.interval_s):
                return

    # ---------------------------------------------------------- one cycle
    def _key_info(self, key: WorkloadKey, tgt: TuneTarget):
        """(signature, static, space, features, default energy) for a live
        key — derived once from the workload's deterministic example args."""
        info = self._info.get(key)
        if info is None:
            spec = self.registry.spec(tgt.kernel)
            seed = workload_seed(tgt.kernel, tgt.workload.name,
                                 self.config.tune.seed)
            example = tgt.workload.tensors(np.random.default_rng(seed))
            static = spec.signature_fn(*example)
            sig = json.dumps(static, sort_keys=True)
            space = spec.space_for(**static)
            feats = features_of(static)
            default = Schedule(knobs=space.default_knobs())
            e_default = energy_mod.CostModelEnergy(
                lambda s: spec.program_for(s, **static))(default)
            info = self._info[key] = (sig, static, space, feats, e_default)
        return info

    def _priority(self, key: WorkloadKey, tgt: TuneTarget,
                  share: float) -> float:
        """share x energy headroom / (1 + rounds tuned).

        Headroom is the incumbent's energy relative to the default
        schedule's: an untuned key scores 1.0 (all the headroom), a
        well-tuned one scores its achieved ratio — so busy untuned shapes
        outrank shapes the service has already squeezed, and every key's
        priority decays as rounds accumulate."""
        sig, _, _, _, e_default = self._key_info(key, tgt)
        inc = incumbent_energy(self.live, tgt.kernel, sig)
        headroom = 1.0 if inc is None or e_default <= 0 \
            else min(1.0, inc / e_default)
        return share * headroom / (1.0 + self._rounds.get(key, 0))

    def _tune_and_gate(self, key: WorkloadKey,
                       tgt: TuneTarget) -> GateDecision | None:
        """One incremental search round for ``key`` + the gate's verdict.
        Returns None when the search produced no passing candidate."""
        spec = self.registry.spec(tgt.kernel)
        sig, _, space, feats, _ = self._key_info(key, tgt)
        x0 = self.history.warm_start(tgt.kernel, sig, space, feats)
        if x0 is not None:
            self._c["warm_start_hits"].inc()
            self.log.emit("warm_start", kernel=tgt.kernel,
                          workload=tgt.workload.name,
                          knobs=dict(x0.knobs))
        # fitted policy: greed per kernel from accumulated accepted history
        cfg_t = dataclasses.replace(
            self.config.tune,
            greed=self.history.greed_for(tgt.kernel,
                                         default=self.config.tune.greed))
        self.session.config = cfg_t
        run = self.session.run_workload(tgt.kernel, tgt.workload, x0=x0)
        self._rounds[key] = self._rounds.get(key, 0) + 1
        self._c["tuned"].inc()
        self.log.emit("tuned", kernel=tgt.kernel, workload=tgt.workload.name,
                      energy=run.best_energy, rounds=self._rounds[key],
                      warm_started=x0 is not None)
        candidate = self.shadow.best(tgt.kernel, run.signature)
        if candidate is None:
            return None
        cand_energy = incumbent_energy(self.shadow, tgt.kernel, run.signature)
        decision = self.gate.evaluate(spec, tgt.workload, run.signature,
                                      candidate, cand_energy)
        self.history.record(kernel=tgt.kernel, signature=run.signature,
                            workload=tgt.workload.name, schedule=candidate,
                            energy=cand_energy, improvement=run.improvement,
                            accepted=decision.promoted, features=feats)
        return decision

    def _kernel_stream(self):
        """The service's own CUDA stream as the current one (on the card),
        so a cycle's kernel work never shares the serving thread's."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def run_once(self) -> dict:
        """One full cycle: drain -> prioritize -> search -> gate -> commit ->
        evict.  Synchronous (the daemon and tests call it directly); the
        worker thread runs it on the interval."""
        t0 = time.perf_counter()
        with self._kernel_stream():
            summary = self._cycle_once()
        summary["seconds"] = round(time.perf_counter() - t0, 3)
        self.log.emit("cycle", **summary)
        return summary

    def _cycle_once(self) -> dict:
        self._cycle += 1
        snapshot, now = self.source()
        self.dist.update(snapshot)
        shares = self.dist.shares(now)

        ranked: list[tuple[float, WorkloadKey, TuneTarget]] = []
        for key, share in shares.items():
            if key in self._bad_keys or \
                    self._rounds.get(key, 0) >= self.config.max_rounds:
                continue
            try:
                tgt = self.target_for(key)
                if tgt is None:
                    self._bad_keys.add(key)
                    continue
                ranked.append((self._priority(key, tgt, share), key, tgt))
            except Exception as e:
                # a key the adapter/registry cannot serve must not wedge the
                # cycle — journal and never retry it
                self._bad_keys.add(key)
                self._c["errors"].inc()
                self.log.emit("error", key=key.name,
                              error=f"{type(e).__name__}: {e}"[:500])
        ranked.sort(key=lambda item: -item[0])

        staged: list[PendingPut] = []
        decisions: list[GateDecision] = []
        tuned = 0
        for _, key, tgt in ranked[:self.config.budget]:
            try:
                decision = self._tune_and_gate(key, tgt)
            except Exception as e:
                self._c["errors"].inc()
                self.log.emit("error", key=key.name,
                              error=f"{type(e).__name__}: {e}"[:500])
                continue
            tuned += 1
            if decision is None:
                self._c["rejections"].inc()
                self.log.emit("rejected", kernel=tgt.kernel,
                              workload=tgt.workload.name,
                              reason="no_passing_candidate")
                continue
            decisions.append(decision)
            if decision.promoted:
                staged.append(PendingPut(
                    kernel_name=decision.kernel,
                    signature=decision.signature,
                    schedule=Schedule.from_json(decision.schedule_sig),
                    energy=decision.candidate_energy, tests_passed=True,
                    test_samples=decision.samples, round_id=self._cycle,
                    meta={"autotune": True, "workload": decision.workload,
                          "incumbent_energy": decision.incumbent_energy}))
                self._promoted[key] = (decision.kernel, decision.signature)
                self._c["promotions"].inc()
                self.log.emit("promoted", kernel=decision.kernel,
                              workload=decision.workload,
                              signature=decision.signature,
                              schedule_sig=decision.schedule_sig,
                              energy=decision.candidate_energy,
                              incumbent_energy=decision.incumbent_energy,
                              samples=decision.samples)
            elif decision.reason == "verify_failed":
                self._c["quarantines"].inc()
                self.log.emit("quarantined", kernel=decision.kernel,
                              workload=decision.workload,
                              schedule_sig=decision.schedule_sig,
                              reason=decision.reason,
                              max_err=decision.max_err)
            else:
                self._c["rejections"].inc()
                self.log.emit("rejected", kernel=decision.kernel,
                              workload=decision.workload,
                              reason=decision.reason,
                              energy=decision.candidate_energy,
                              incumbent_energy=decision.incumbent_energy)

        # one commit = one version bump = one engine re-trace per cycle,
        # however many schedules promoted
        if self.staging is not None:
            self.staging.commit(staged)
        else:
            self.live.commit(staged)
        evicted = self._evict(shares)
        if self.state is not None and len(self.state.completed) > 256:
            # the journal's completed list only matters to tune-session
            # resumes; the service reuses the journal for quarantine, so
            # bound its growth over a long-running deployment
            self.state.completed = self.state.completed[-128:]
            self.state.save()

        quarantined = sum(1 for d in decisions
                          if d.reason == "verify_failed")
        self._c["cycles"].inc()
        return {"cycle": self._cycle, "candidates": len(ranked),
                "tuned": tuned, "promoted": len(staged),
                "quarantined": quarantined, "evicted": evicted,
                "keys": len(self.dist)}

    def _evict(self, shares: Mapping[WorkloadKey, float]) -> int:
        """Retire promoted keys whose staleness-weighted share fell below
        the floor: their entries leave the live store (engines fall back to
        the default schedule on the next swap) and their round budget
        resets, so returning traffic re-earns its tuning."""
        evicted = 0
        for key in list(self._promoted):
            if shares.get(key, 0.0) >= self.config.share_floor:
                continue
            kernel, sig = self._promoted.pop(key)
            if self.staging is not None:
                dropped = (len(self.live.entries(kernel, sig))
                           + self.staging.pending(kernel, sig))
                self.staging.drop(kernel, sig)
            else:
                dropped = self.live.drop(kernel, sig)
            self._rounds.pop(key, None)
            if dropped:
                evicted += 1
                self._c["evictions"].inc()
                self.log.emit("evicted", kernel=kernel, signature=sig,
                              dropped=dropped, key=key.name)
        return evicted

    # ------------------------------------------------------------- surface
    def metrics(self) -> dict[str, float]:
        return {name: float(c.value) for name, c in self._c.items()}
