"""TuningSession — the offline search orchestrator (paper §4.1 at fleet scale).

The paper runs SIP offline per kernel; production needs the search to run
uniformly over *many* kernels and deployment shapes.  A session iterates the
registry's declarative :class:`~repro_torch.core.registry.Workload` suites,
derives a stable per-(kernel, workload) seed (tuning a subset, or
reordering, never changes another workload's inputs or trajectory), and
persists every result into ONE :class:`~repro_torch.core.cache.ScheduleCache` that
deployment then activates via ``schedule_cache``.

With ``chains=1`` a session workload is bit-identical to calling
``SipKernel.tune`` directly with the same seed — the session adds
orchestration, not search behavior.

Crash safety: give the session a :class:`~repro_torch.tuning.state.SearchState`
journal (or a path) and it records workload progress atomically next to the
cache.  A killed session re-run with ``resume=True`` skips completed
workloads, purges the in-flight workload's partial cache entries
(:meth:`ScheduleCache.drop`) and re-runs it from its deterministic seed, so
the resumed cache converges to exactly the uninterrupted result.  The
journal also persists each workload's quarantine (schedules whose evaluation
crashed or blew ``TuneConfig.eval_deadline_s``) so a resume never re-pays a
known-bad candidate's deadline.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.cache import ScheduleCache
from repro_torch.core.jit import TuneConfig
from repro_torch.core.registry import (KernelRegistry, Workload,
                                       cache_for_path, registry,
                                       workload_seed)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.tuning.state import SearchState


class SimulatedCrash(RuntimeError):
    """Deterministic mid-session death for chaos tests and CI.

    Raised by ``die_after=N`` at the torn-state point of the N-th workload
    tuned this run: its cache entries are written but the journal still says
    ``in_progress`` — the worst case a real kill can leave behind, and
    exactly what the resume path's purge-and-rerun must recover from.
    ``launch/tune.py`` maps it to :data:`EXIT_CODE`.
    """

    EXIT_CODE = 3


@dataclasses.dataclass(frozen=True)
class WorkloadRun:
    """Outcome of tuning one (kernel, workload) pair."""

    kernel: str
    workload: str
    signature: str                 # SipKernel.sig_str of the example args
    seed: int                      # workload_seed(kernel, workload, base)
    results: tuple[Any, ...]       # AnnealResult per round
    best_energy: float

    @property
    def improvement(self) -> float:
        return max(r.improvement for r in self.results)


class TuningSession:
    """Orchestrates offline SIP search over registered kernels.

    ``cache`` is the single persistent store every tuned schedule lands in;
    ``config`` is the shared search configuration (its ``seed`` is the
    session base seed — each workload folds it into its own stable seed).

    ``state`` (a :class:`SearchState` or a path) enables crash-safe
    journaling; ``keep_going`` records a workload whose tuning raises in the
    journal's ``failed`` list and moves on instead of aborting the session;
    ``die_after`` injects a :class:`SimulatedCrash` for tests/CI.
    ``device`` is where the kernels run: each workload's numpy example
    arguments become tensors there (the CPU runs each program's torch face;
    CUDA emits, builds and launches the kernels).
    """

    def __init__(self, cache: ScheduleCache | str | None = None,
                 config: TuneConfig | None = None,
                 registry_: KernelRegistry | None = None, *,
                 state: SearchState | str | None = None,
                 keep_going: bool = False,
                 die_after: int | None = None,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TuningSession: CUDA was asked for and is not "
                               "available; pass device='cpu' for the CPU")
        if isinstance(cache, str):
            cache = cache_for_path(cache)   # interned: serving scopes over
            #                                 the same path share this store
        self.cache = cache if cache is not None else ScheduleCache()
        self.config = (config if config is not None else TuneConfig()).validate()
        self.registry = registry_ if registry_ is not None else registry
        if isinstance(state, str):
            state = SearchState.load(state) or SearchState(path=state)
        self.state = state
        self.keep_going = keep_going
        self.die_after = die_after
        self.failures: list[dict[str, str]] = []
        self._tuned_this_run = 0
        # session-local instance memo: workloads of one kernel share an
        # instance (and its build caches) within the session, without
        # pinning per-session instances in the process-wide registry forever
        self._instances: dict[str, Any] = {}

    def _kernel(self, name: str):
        inst = self._instances.get(name)
        if inst is None:
            inst = self._instances[name] = \
                self.registry.spec(name).instantiate(cache=self.cache)
        return inst

    def _fingerprint(self, names: Sequence[str], suite: str) -> dict[str, Any]:
        # JSON round-trip so equality against the reloaded journal is exact
        return json.loads(json.dumps(
            {"suite": suite, "kernels": sorted(names),
             "config": dataclasses.asdict(self.config)}))

    def run(self, kernels: Sequence[str] | None = None,
            suite: str = "default", verbose: bool = False, *,
            resume: bool = False) -> list[WorkloadRun]:
        """Tune every workload of ``suite`` for ``kernels`` (default: every
        registered kernel).  Unknown kernel names raise before any tuning.

        With ``resume=True`` and a matching journal, completed workloads are
        skipped (and excluded from the returned list — only work performed
        by THIS call is returned) and the stale in-flight workload's partial
        cache entries are dropped before it re-runs.
        """
        names = list(kernels) if kernels else self.registry.names()
        plan: list[tuple[str, Workload]] = []
        for name in names:
            spec = self.registry.spec(name)      # raises on unknown kernel
            wls = spec.workloads_in(suite)
            if verbose and not wls:
                print(f"[session] {name}: no {suite!r} workloads, skipping")
            plan.extend((name, wl) for wl in wls)

        done: set[tuple[str, str]] = set()
        if self.state is not None:
            fp = self._fingerprint(names, suite)
            if resume and self.state.matches(fp):
                done = self.state.completed_keys()
                stale = self.state.in_progress
                if stale is not None:
                    dropped = self.cache.drop(stale["kernel"],
                                              stale["signature"])
                    obs_metrics.counter("ft.resume_purged").inc(dropped)
                    obs_trace.instant("ft.resume_purge", **stale,
                                      dropped=dropped)
                    if verbose:
                        print(f"[session] resume: purged {dropped} partial "
                              f"entries of {stale['kernel']} · "
                              f"{stale['workload']}")
                if verbose and done:
                    print(f"[session] resume: skipping {len(done)} "
                          f"completed workloads")
            else:
                if resume:
                    warnings.warn(
                        "TuningSession: journal fingerprint does not match "
                        "this run (different suite/kernels/config) — "
                        "starting fresh instead of resuming",
                        RuntimeWarning, stacklevel=2)
                self.state.completed = []
                self.state.failed = []
                self.state.in_progress = None
                self.state.quarantine = {}
            self.state.fingerprint = fp
            self.state.save()

        runs: list[WorkloadRun] = []
        for name, wl in plan:
            if (name, wl.name) in done:
                continue
            try:
                runs.append(self.run_workload(name, wl, verbose=verbose))
            except SimulatedCrash:
                raise
            except Exception as e:
                if not self.keep_going:
                    raise
                msg = f"{type(e).__name__}: {e}"
                self.failures.append({"kernel": name, "workload": wl.name,
                                      "error": msg})
                obs_metrics.counter("ft.workload_failed").inc()
                obs_trace.instant("ft.workload_failed", kernel=name,
                                  workload=wl.name, error=msg[:200])
                if self.state is not None:
                    self.state.mark_failed(name, wl.name, msg)
                if verbose:
                    print(f"[session] {name} · {wl.name} FAILED "
                          f"({msg}); continuing")
        return runs

    def run_workload(self, kernel: str, workload: Workload,
                     verbose: bool = False, *,
                     x0: Any | None = None) -> WorkloadRun:
        """Tune one (kernel, workload) pair, seeded independently of every
        other pair in the session.  ``x0`` (a :class:`Schedule`) warm-starts
        the search from a known-good neighbor instead of the space default —
        the autotune service's history seam; it must be compatible with the
        workload's knob space (``SipKernel.tune`` raises otherwise)."""
        seed = workload_seed(kernel, workload.name, self.config.seed)
        args = workload.tensors(np.random.default_rng(seed), self.device)
        kern = self._kernel(kernel)
        sig = kern.sig_str(kern.static_of(*args))
        quarantine: set[str] | None = None
        if self.state is not None:
            quarantine = self.state.quarantine_for(kernel, workload.name)
            self.state.mark_in_progress(kernel, workload.name, sig)
        if verbose:
            print(f"[session] {kernel} · {workload.name} (seed={seed})")
        with obs_trace.span("tune.workload", kernel=kernel,
                            workload=workload.name, seed=seed) as sp:
            results = kern.tune(args,
                                dataclasses.replace(self.config, seed=seed),
                                verbose=verbose, quarantine=quarantine,
                                x0=x0)
            sp["best_energy"] = min(r.best_raw for r in results)
        obs_metrics.counter("tune.workloads").inc()
        best = min(r.best_raw for r in results)
        if self.state is not None and quarantine:
            self.state.save_quarantine(kernel, workload.name, quarantine)
        self._tuned_this_run += 1
        if self.die_after is not None and self._tuned_this_run >= self.die_after:
            # die at the torn-state point: cache entries durably written,
            # journal still in_progress (see SimulatedCrash docstring)
            raise SimulatedCrash(
                f"die_after={self.die_after}: simulated crash after tuning "
                f"{kernel} · {workload.name}")
        if self.state is not None:
            self.state.mark_completed(kernel, workload.name, signature=sig,
                                      seed=seed, best_energy=best)
        return WorkloadRun(kernel=kernel, workload=workload.name,
                           signature=sig, seed=seed, results=tuple(results),
                           best_energy=best)
