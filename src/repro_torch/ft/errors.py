"""Fault-tolerance control-flow exceptions.

The training loop signals failures by raising; the supervisor
(:mod:`repro_torch.ft.supervisor`) is the only intended catcher.  Keeping them
in their own module breaks the import cycle between ``train/loop.py`` (raises)
and ``ft/supervisor.py`` (catches and re-enters the loop).
"""

from __future__ import annotations

from typing import Any


class TrainFailure(RuntimeError):
    """Base class for failures the supervisor knows how to recover from."""

    def __init__(self, msg: str, *, step: int | None = None,
                 info: dict[str, Any] | None = None):
        super().__init__(msg)
        self.step = step
        self.info = info or {}


class WorkerKilled(TrainFailure):
    """A worker process died mid-step (chaos ``crash`` fault, or a real
    uncaught crash surfaced by the launch fabric)."""


class RestartRequired(TrainFailure):
    """``FTManager.decide()`` returned RESTART_FROM_CKPT: relaunch on the
    same mesh from the newest verified checkpoint."""


class ReshapeRequired(TrainFailure):
    """``FTManager.decide()`` returned ELASTIC_RESHAPE: capacity was lost
    permanently; ``target`` is the (shape, axes) ladder mesh to rebuild."""

    def __init__(self, msg: str, *, target: tuple, step: int | None = None,
                 info: dict[str, Any] | None = None):
        super().__init__(msg, step=step, info=info)
        self.target = target


class NonFiniteLossError(TrainFailure):
    """The loss went NaN/inf at ``step``.  The supervisor rolls back to the
    last verified checkpoint and skips a window of data steps around the
    offending batch instead of crashing (or, worse, training on garbage)."""

    def __init__(self, step: int, loss: float):
        super().__init__(f"non-finite loss {loss!r} at step {step}", step=step)
        self.loss = loss


class RestartBudgetExhausted(RuntimeError):
    """The supervisor gave up: more failures than ``max_restarts`` allows."""
