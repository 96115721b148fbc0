"""Fault-tolerance manager: heartbeats, straggler detection, restart policy,
and elastic re-meshing decisions.

At 1000+-node scale the failure model is: workers heartbeat step latencies to
a coordinator; the coordinator (this class) detects dead nodes (missed
heartbeats), stragglers (latency z-score), and decides between
  * CONTINUE          — healthy
  * RESTART_FROM_CKPT — a worker died; relaunch on the same mesh
  * ELASTIC_RESHAPE   — capacity permanently lost; pick the largest viable
                        mesh from survivors and restore (checkpoint/ckpt.py's
                        mesh-independent restore makes this a pure relaunch)
The coordinator is deliberately transport-agnostic (heartbeats are fed in by
whatever fabric exists — GRPC, GCS, SLURM); tests drive it with synthetic
timelines, and launch/train.py wires it to the local loop.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Any


class Action(enum.Enum):
    CONTINUE = "continue"
    RESTART_FROM_CKPT = "restart"
    ELASTIC_RESHAPE = "elastic"


@dataclasses.dataclass
class FTConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_zscore: float = 3.0
    straggler_min_samples: int = 16
    max_restarts: int = 100
    chips_per_worker: int = 8          # devices per host, as the reference
    # meshes we may elastically fall back to, largest first: (shape, axes)
    mesh_ladder: tuple = (
        ((2, 16, 16), ("pod", "data", "model")),
        ((16, 16), ("data", "model")),
        ((8, 16), ("data", "model")),
        ((4, 16), ("data", "model")),
    )


@dataclasses.dataclass
class WorkerState:
    last_seen: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    alive: bool = True


class FTManager:
    def __init__(self, n_workers: int, cfg: FTConfig | None = None,
                 clock=time.monotonic):
        # cfg=None -> a fresh FTConfig per manager: a shared default instance
        # would alias ladder/threshold mutations across managers (the same
        # mutable-default bug class as TuneConfig's)
        self.cfg = cfg if cfg is not None else FTConfig()
        self.clock = clock
        self.workers = {i: WorkerState(last_seen=clock())
                        for i in range(n_workers)}
        self.restarts = 0
        self.events: list[dict[str, Any]] = []

    # ------------------------------------------------------------ heartbeats
    def refresh(self, now: float | None = None) -> None:
        """Reset every live worker's liveness deadline.  The supervisor
        calls this when an attempt (re)starts: time spent in backoff or
        checkpoint restore must not read as missed heartbeats."""
        now = self.clock() if now is None else now
        for w in self.workers.values():
            if w.alive:
                w.last_seen = now

    def heartbeat(self, worker: int, step_latency_s: float | None = None):
        w = self.workers[worker]
        w.last_seen = self.clock()
        w.alive = True
        if step_latency_s is not None:
            w.latencies.append(step_latency_s)
            if len(w.latencies) > 256:
                del w.latencies[:128]

    def dead_workers(self) -> list[int]:
        now = self.clock()
        return [i for i, w in self.workers.items()
                if w.alive and now - w.last_seen > self.cfg.heartbeat_timeout_s]

    # ------------------------------------------------------------ stragglers
    def stragglers(self) -> list[int]:
        """Workers whose recent latency is an outlier vs the fleet median.

        Median-ratio rather than z-score: with few workers a single big
        outlier inflates the stddev enough to hide itself; the median is
        robust to it.  A worker is a straggler when its recent mean exceeds
        ``straggler_zscore`` x the fleet median (the config knob is reused
        as the ratio)."""
        means = {i: sum(w.latencies[-16:]) / len(w.latencies[-16:])
                 for i, w in self.workers.items()
                 if w.alive and len(w.latencies) >= self.cfg.straggler_min_samples}
        if len(means) < 4:
            return []
        vals = sorted(means.values())
        med = vals[len(vals) // 2]
        if med <= 0:
            return []
        return [i for i, v in means.items()
                if v / med > self.cfg.straggler_zscore]

    # --------------------------------------------------------------- policy
    def decide(self) -> tuple[Action, dict[str, Any]]:
        dead = self.dead_workers()
        if dead:
            for i in dead:
                self.workers[i].alive = False
            self.restarts += 1
            alive = sum(w.alive for w in self.workers.values())
            info = {"dead": dead, "alive": alive, "restarts": self.restarts}
            self.events.append({"t": self.clock(), "action": "failure", **info})
            if self.restarts > self.cfg.max_restarts:
                raise RuntimeError("restart budget exhausted")
            # permanent capacity loss -> reshape; transient -> plain restart
            target = self.viable_mesh(alive)
            if target is not None and target != self.cfg.mesh_ladder[0]:
                info["mesh"] = target
                return Action.ELASTIC_RESHAPE, info
            return Action.RESTART_FROM_CKPT, info
        stragglers = self.stragglers()
        if stragglers:
            self.events.append({"t": self.clock(), "action": "straggler",
                                "workers": stragglers})
            return Action.CONTINUE, {"stragglers": stragglers,
                                     "mitigation": "reroute-or-replace"}
        return Action.CONTINUE, {}

    def adopt(self, action: Action, info: dict[str, Any]) -> None:
        """Take the verdict another manager reached from the same
        heartbeats (a mesh's first rank decides for every rank): its dead
        workers and restart count."""
        if action is Action.CONTINUE:
            return
        for i in info["dead"]:
            self.workers[i].alive = False
        self.restarts = info["restarts"]
        self.events.append({"t": self.clock(), "action": "failure",
                            **{k: info[k] for k in ("dead", "alive",
                                                    "restarts")}})

    def viable_mesh(self, alive_workers: int):
        """Largest ladder mesh that fits the surviving worker count
        (``cfg.chips_per_worker`` devices per host)."""
        chips = alive_workers * self.cfg.chips_per_worker
        for shape, axes in self.cfg.mesh_ladder:
            need = math.prod(shape)
            if need <= chips:
                return (shape, axes)
        return None
