"""Deterministic fault injection for the training/tuning resilience layer.

A :class:`FaultPlan` is a seeded, declarative list of faults — worker
crashes, heartbeat kills, stragglers, checkpoint corruption, non-finite
losses — and a :class:`ChaosEngine` arms one plan against a running loop.
Everything is a pure function of (plan, step): the same plan against the
same run injects the same faults at the same points, so chaos runs are
replayable in tests and comparable against an uninterrupted baseline
(the differential gate in ``tests/test_torch_ft.py``).

Drivable from the CLI::

    python -m repro_torch.launch.train ... --chaos "crash@9,corrupt@12,nan@15"
    python -m repro_torch.launch.train ... --chaos random:7   # seeded plan

Fault grammar (comma list of ``kind@step[:opt...]``):

* ``crash@S``            — raise :class:`WorkerKilled` entering step S (once)
* ``kill@S[:wW][:perm]`` — stop worker W's heartbeats from step S;
  transient kills resume on the next attempt, ``perm`` never comes back
* ``straggle@S[:wW][:xF][:dD]`` — inflate worker W's reported step latency
  by F for D steps (default: rest of the attempt)
* ``nan@S[:sticky]``     — non-finite loss at step S; ``sticky`` re-fires
  every time step S's original batch is used (a genuinely bad batch — only
  the supervisor's skip-window makes progress possible)
* ``corrupt@S[:truncate|bitflip|manifest]`` — damage the first checkpoint
  written at/after step S, mid-write from the loop's point of view
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.ft.errors import WorkerKilled
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

KINDS = ("crash", "kill", "straggle", "nan", "corrupt")
CORRUPT_MODES = ("truncate", "bitflip", "manifest")


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    worker: int = 0
    factor: float = 8.0        # straggle: reported-latency multiplier
    duration: int = 0          # straggle: steps it lasts (0 = rest of attempt)
    sticky: bool = False       # nan: re-fires whenever step's batch is used
    permanent: bool = False    # kill: worker never rejoins
    mode: str = "truncate"     # corrupt: truncate | bitflip | manifest

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.kind == "corrupt" and self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r} "
                             f"(expected one of {CORRUPT_MODES})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")

    def to_spec(self) -> str:
        opts = []
        if self.kind in ("kill", "straggle") and self.worker:
            opts.append(f"w{self.worker}")
        if self.kind == "straggle":
            if self.factor != 8.0:
                opts.append(f"x{self.factor:g}")
            if self.duration:
                opts.append(f"d{self.duration}")
        if self.kind == "kill" and self.permanent:
            opts.append("perm")
        if self.kind == "nan" and self.sticky:
            opts.append("sticky")
        if self.kind == "corrupt" and self.mode != "truncate":
            opts.append(self.mode)
        return "@".join([self.kind, str(self.step)]) + \
            "".join(":" + o for o in opts)


def _parse_fault(item: str) -> Fault:
    head, _, rest = item.strip().partition("@")
    if not rest:
        raise ValueError(f"fault {item!r} is missing '@step'")
    parts = rest.split(":")
    try:
        step = int(parts[0])
    except ValueError:
        raise ValueError(f"fault {item!r}: step {parts[0]!r} is not an int")
    kw: dict = {}
    for opt in parts[1:]:
        if opt == "perm":
            kw["permanent"] = True
        elif opt == "sticky":
            kw["sticky"] = True
        elif opt in CORRUPT_MODES:
            kw["mode"] = opt
        elif opt.startswith("w"):
            kw["worker"] = int(opt[1:])
        elif opt.startswith("x"):
            kw["factor"] = float(opt[1:])
        elif opt.startswith("d"):
            kw["duration"] = int(opt[1:])
        else:
            raise ValueError(f"fault {item!r}: unknown option {opt!r}")
    return Fault(kind=head, step=step, **kw)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, immutable set of faults.  Construct via :meth:`parse`
    (explicit CLI spec) or :meth:`random` (seeded generation)."""

    faults: tuple[Fault, ...] = ()

    @classmethod
    def parse(cls, spec: str, *, n_workers: int = 1,
              total_steps: int | None = None) -> "FaultPlan":
        """Parse a comma-separated fault spec; ``random:SEED`` delegates to
        :meth:`random` (which needs ``total_steps``)."""
        spec = spec.strip()
        if spec.startswith("random:"):
            if total_steps is None:
                raise ValueError("random chaos plans need total_steps")
            return cls.random(int(spec.split(":", 1)[1]),
                              total_steps=total_steps, n_workers=n_workers)
        faults = tuple(_parse_fault(p) for p in spec.split(",") if p.strip())
        if not faults:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls(faults)

    @classmethod
    def random(cls, seed: int, *, total_steps: int,
               n_workers: int = 1, n_faults: int = 3) -> "FaultPlan":
        """A seeded plan: ``n_faults`` faults at distinct mid-run steps.
        Deterministic — the same (seed, total_steps, n_workers) always
        yields the same plan."""
        rng = np.random.default_rng(seed)
        lo, hi = max(1, total_steps // 8), max(2, total_steps - 2)
        steps = sorted(rng.choice(np.arange(lo, hi), size=min(
            n_faults, hi - lo), replace=False).tolist())
        kinds = rng.choice(["crash", "kill", "straggle", "nan", "corrupt"],
                           size=len(steps)).tolist()
        faults = []
        for step, kind in zip(steps, kinds):
            kw: dict = {}
            if kind in ("kill", "straggle"):
                kw["worker"] = int(rng.integers(0, n_workers))
            if kind == "corrupt":
                kw["mode"] = str(rng.choice(CORRUPT_MODES))
            faults.append(Fault(kind=kind, step=int(step), **kw))
        return cls(tuple(faults))

    def to_spec(self) -> str:
        return ",".join(f.to_spec() for f in self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)


class ChaosEngine:
    """Arms a :class:`FaultPlan` against a live loop.

    The engine is held by the *supervisor* (it outlives train attempts) so
    fire-once faults stay fired across restarts — a crash injected at step
    N must not re-kill the relaunched attempt replaying step N, while a
    ``sticky`` nan keyed to a data step re-fires until the supervisor skips
    that batch.  Every injection lands in ``events`` and in ``ft.chaos.*``
    counters/trace instants.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.events: list[dict] = []
        self._fired: set[int] = set()          # indices of one-shot faults
        self._suppressed: dict[int, bool] = {}  # worker -> permanent?
        self._m = obs_metrics.active_registry().counter("ft.chaos.injected")

    # ------------------------------------------------------------- lifecycle
    def on_attempt_start(self) -> None:
        """A new train attempt begins: transiently-killed workers rejoin."""
        self._suppressed = {w: True for w, perm in self._suppressed.items()
                            if perm}

    def _record(self, fault: Fault, step: int, **extra) -> None:
        self._m.inc()
        ev = {"kind": fault.kind, "fault_step": fault.step, "step": step,
              **extra}
        self.events.append(ev)
        obs_trace.instant("ft.chaos", **ev)

    # ------------------------------------------------------------ injection
    def on_step_start(self, step: int) -> None:
        """Arm step-keyed faults: raises :class:`WorkerKilled` once for a
        ``crash`` fault, starts heartbeat suppression for ``kill`` faults."""
        for i, f in enumerate(self.plan):
            if f.kind == "crash" and f.step == step and i not in self._fired:
                self._fired.add(i)
                self._record(f, step)
                raise WorkerKilled(f"chaos: worker crash at step {step}",
                                   step=step)
        for i, f in enumerate(self.plan):
            if f.kind == "kill" and f.step == step and i not in self._fired:
                self._fired.add(i)
                self._suppressed[f.worker] = f.permanent
                self._record(f, step, worker=f.worker, permanent=f.permanent)

    def heartbeat_suppressed(self, worker: int) -> bool:
        return worker in self._suppressed

    def latency_factor(self, worker: int, step: int) -> float:
        """Multiplier applied to the latency ``worker`` reports at ``step``."""
        factor = 1.0
        for f in self.plan:
            if f.kind != "straggle" or f.worker != worker:
                continue
            end = f.step + f.duration if f.duration else float("inf")
            if f.step <= step < end:
                factor *= f.factor
        return factor

    def filter_loss(self, step: int, loss: float, *,
                    substituted: bool = False) -> float:
        """Return the (possibly poisoned) loss for ``step``.

        ``substituted=True`` means the loop replaced this step's batch (the
        supervisor's skip-window) — a sticky nan models data-dependent
        corruption, so it does not fire against the substitute batch."""
        for i, f in enumerate(self.plan):
            if f.kind != "nan" or f.step != step:
                continue
            if f.sticky:
                if not substituted:
                    self._record(f, step, sticky=True)
                    return float("nan")
            elif i not in self._fired:
                self._fired.add(i)
                self._record(f, step)
                return float("nan")
        return loss

    def wants_corrupt(self, saved_step: int) -> bool:
        return any(f.kind == "corrupt" and f.step <= saved_step
                   and i not in self._fired
                   for i, f in enumerate(self.plan))

    def corrupt_checkpoint(self, directory: str, saved_step: int) -> None:
        """Damage the on-disk checkpoint for ``saved_step`` (call after the
        write has finished — the loop joins the async writer first)."""
        for i, f in enumerate(self.plan):
            if f.kind != "corrupt" or f.step > saved_step \
                    or i in self._fired:
                continue
            self._fired.add(i)
            path = os.path.join(directory, f"step_{saved_step:08d}")
            corrupt_checkpoint_dir(path, f.mode)
            self._record(f, saved_step, mode=f.mode, path=path)


def corrupt_checkpoint_dir(path: str, mode: str = "truncate") -> None:
    """Damage one ``step_*`` checkpoint directory in a detectable way.

    Shared by the chaos engine and the checkpoint corruption tests so both
    exercise the exact same failure shapes ``CheckpointManager.verify``
    must catch."""
    arrays = os.path.join(path, "arrays.npz")
    manifest = os.path.join(path, "manifest.json")
    if mode == "truncate":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as fh:
            fh.truncate(max(1, size // 2))
    elif mode == "bitflip":
        with open(arrays, "r+b") as fh:
            fh.seek(os.path.getsize(arrays) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
    elif mode == "manifest":
        with open(manifest) as fh:
            m = json.load(fh)
        for k in m.get("hashes", {}):
            m["hashes"][k] = "0" * 64
        with open(manifest, "w") as fh:
            json.dump(m, fh)
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
