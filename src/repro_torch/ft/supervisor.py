"""Supervisor loop — the consumer of ``FTManager.decide()``.

The train loop is a plain function that RAISES on failure (worker death,
FT-manager verdicts, non-finite loss); this module is the outer shell that
catches, repairs, and re-enters it:

* :class:`~repro_torch.ft.errors.WorkerKilled` / ``RestartRequired`` —
  re-enter ``train()`` on the same mesh.  The loop restores from the newest
  *verified* checkpoint itself, so a restart is a pure relaunch; attempts
  are spaced by bounded exponential backoff.
* :class:`~repro_torch.ft.errors.ReshapeRequired` — capacity was lost for
  good: rebuild the mesh from the failure's ladder target
  (``mesh_factory``) and relaunch from the mesh-independent checkpoint,
  which the loop reshards onto the new mesh.  On a job of ranks every
  rank runs a supervisor and gets the same verdict (the loop broadcasts
  the first rank's), so every rank calls the factory, which builds the
  mesh collectively (``launch.mesh.mesh_for``); ranks the smaller mesh
  leaves out return from ``train`` at once.  A one-device run
  (``mesh=None``) without a factory relaunches on one device; a mesh
  without a factory re-raises, never shrinking to one device unseen.
* :class:`~repro_torch.ft.errors.NonFiniteLossError` — roll back to the last
  checkpoint and widen the data skip-window over the offending step so the
  bad batch is replaced with a disjoint substitute instead of re-exploding.

Every recovery lands in ``ft.*`` counters and trace instants, and in the
returned result's ``supervisor`` summary.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.ft.chaos import ChaosEngine
from repro_torch.ft.errors import (NonFiniteLossError, ReshapeRequired,
                             RestartBudgetExhausted, RestartRequired,
                             TrainFailure, WorkerKilled)
from repro_torch.ft.manager import FTManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 8               # attempts beyond the first
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    nan_skip_window: int = 1            # data steps skipped per nan rollback


class Supervisor:
    """Runs ``train_fn`` to completion across failures.

    ``train_fn(mesh=..., skip_data_steps=...)`` is the (partially applied)
    training entry point — usually :func:`repro_torch.train.loop.train` with
    everything but the supervisor-owned arguments bound.  ``mesh_factory``
    maps an :class:`~repro_torch.ft.errors.ReshapeRequired` ladder target
    ``(shape, axes)`` to a live mesh; without one, an elastic event on a
    one-device run relaunches it there, and on a mesh re-raises.
    """

    def __init__(self, train_fn: Callable[..., dict[str, Any]], *,
                 ft: FTManager | None = None,
                 chaos: ChaosEngine | None = None,
                 mesh: Any = None,
                 mesh_factory: Callable[[tuple], Any] | None = None,
                 cfg: SupervisorConfig | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.train_fn = train_fn
        self.ft = ft
        self.chaos = chaos
        self.mesh = mesh
        self.mesh_factory = mesh_factory
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.sleep = sleep
        self.events: list[dict[str, Any]] = []
        self.skip_data_steps: set[int] = set()

    # ---------------------------------------------------------------- events
    def _record(self, kind: str, attempt: int, **info) -> None:
        reg = obs_metrics.active_registry()
        reg.counter(f"ft.{kind}").inc()
        ev = {"kind": kind, "attempt": attempt, **info}
        self.events.append(ev)
        obs_trace.instant(f"ft.{kind}", **{k: v for k, v in ev.items()
                                           if not isinstance(v, (list, dict))})

    def _backoff(self, restarts: int) -> float:
        c = self.cfg
        return min(c.backoff_base_s * c.backoff_factor ** (restarts - 1),
                   c.backoff_max_s)

    # ------------------------------------------------------------------ run
    def run(self) -> dict[str, Any]:
        """Train to completion; returns the final train result annotated
        with a ``supervisor`` summary.  Raises
        :class:`RestartBudgetExhausted` after ``max_restarts`` failures."""
        mesh = self.mesh
        restarts = 0
        while True:
            if self.ft is not None:
                self.ft.refresh()       # a backoff pause is not a death
            if self.chaos is not None:
                self.chaos.on_attempt_start()
            try:
                with obs_trace.span("ft.attempt", attempt=restarts,
                                    skip=len(self.skip_data_steps)):
                    res = self.train_fn(
                        mesh=mesh,
                        skip_data_steps=frozenset(self.skip_data_steps))
                res["supervisor"] = {
                    "attempts": restarts + 1,
                    "events": list(self.events),
                    "skip_data_steps": sorted(self.skip_data_steps),
                    "final_mesh": _mesh_summary(mesh),
                }
                return res
            except NonFiniteLossError as e:
                lo = e.step
                self.skip_data_steps.update(
                    range(lo, lo + self.cfg.nan_skip_window))
                self._record("nonfinite_rollback", restarts, step=e.step,
                             skip_window=self.cfg.nan_skip_window)
            except ReshapeRequired as e:
                if self.mesh_factory is not None:
                    mesh = self.mesh_factory(e.target)
                elif mesh is not None:
                    raise
                self._record("elastic_reshape", restarts, step=e.step,
                             target=list(e.target[0]), **_safe_info(e))
            except (WorkerKilled, RestartRequired) as e:
                self._record("restart", restarts, step=e.step,
                             cause=type(e).__name__, **_safe_info(e))
            restarts += 1
            if restarts > self.cfg.max_restarts:
                raise RestartBudgetExhausted(
                    f"supervisor gave up after {restarts - 1} restarts "
                    f"(events: {[e['kind'] for e in self.events]})")
            delay = self._backoff(restarts)
            obs_metrics.active_registry().histogram(
                "ft.backoff_s").record(delay)
            self.sleep(delay)


def _mesh_summary(mesh: Any) -> Any:
    """(shape, axes) for a mesh object (``shape`` and ``axis_names``): the
    mesh the run finished on; whatever the caller passed otherwise
    (tests drive the supervisor with stand-in mesh objects)."""
    if mesh is None:
        return None
    if hasattr(mesh, "shape") and hasattr(mesh, "axis_names"):
        return (tuple(mesh.shape.values()), tuple(mesh.axis_names))
    return mesh


def _safe_info(e: TrainFailure) -> dict[str, Any]:
    """Failure info fields that are safe to splat into an event record."""
    return {k: v for k, v in e.info.items()
            if isinstance(v, (str, int, float, bool))}
