"""Training loop: the step, checkpoint/restart, heartbeats and metrics (the
port of ``repro/train/loop.py``).

The loop is a plain function over explicit state so that the supervisor
(:mod:`repro_torch.ft.supervisor`) can kill and relaunch it idempotently:
everything it needs to resume is (checkpoint dir, step), and the data
pipeline is stateless-resumable (``data/pipeline.py``).

Failure contract: the loop RAISES (:mod:`repro_torch.ft.errors`) and the
supervisor catches.  ``FTManager.decide()`` is consulted every step, a
non-finite loss raises ``NonFiniteLossError``, and a chaos plan
(:mod:`repro_torch.ft.chaos`) can inject any of these deterministically.
Restores go through ``restore_latest``, so a corrupt newest checkpoint
falls back to the previous verified step.  Whatever the loop raises, it
first joins its in-flight checkpoint write, so a relaunch never reads a
directory that a writer is still changing.

On a mesh (``launch/mesh.py``; one process a rank, every rank runs this
loop) each rank holds its shards of the params and moments, laid out by
``steps.param_shardings`` under the rules of the caller's
``partition.mesh_rules`` scope (``DEFAULT_RULES`` outside one), and takes
the sharded step (``steps.sharded_train_step``) on the global batch.
Checkpoints are whole arrays written by the mesh's first rank, and a
restore reshards them onto the current mesh.
The FT verdict is the first rank's: it decides and broadcasts, so every
rank raises the same failure at the same step.  A rank that an elastic
reshape leaves out of the mesh returns at once (``outside_mesh``).

Compiled dispatch: on one CUDA device the step runs as a captured CUDA
graph (:class:`~repro_torch.train.graphs.TrainGraph`, ``TrainConfig.
step_graphs``), the reference's jitted step with its state donated: the
first step warms up and captures it, every later one copies its batch in
and replays it.  A restore, a rollback or an elastic restart re-enters
:func:`train`, which captures anew over the restored state.  The sharded
step (its seams are gloo collectives, host operations) stays eager.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Collection

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.ft.chaos import ChaosEngine
from repro_torch.ft.errors import (NonFiniteLossError, ReshapeRequired,
                                   RestartRequired)
from repro_torch.ft.manager import Action, FTManager
from repro_torch.kernels import _build
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw
from repro_torch.train.graphs import TrainGraph

#: the default checkpoint directory, inside the checkout (gitignored)
DEFAULT_CKPT_DIR = str(_build.BUILD_DIR.parent / "ckpt")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = DEFAULT_CKPT_DIR
    ckpt_keep: int = 3
    log_every: int = 10
    num_microbatches: int = 1
    async_ckpt: bool = True
    seed: int = 0
    # metrics history returned by train(): None keeps every step (small
    # runs/tests); an int keeps only the newest N entries (long runs must
    # not grow an unbounded list of per-step dicts)
    log_history: int | None = None
    device: str = "cuda"
    # the one-device step as a captured CUDA graph (train.graphs); None:
    # on when the device is CUDA and there is no mesh.  True on the CPU
    # runs the same static-buffer step eagerly; False: eager dispatch
    step_graphs: bool | None = None


def state_shardings(mcfg: ModelConfig, mesh) -> dict[str, Any]:
    """The NamedShardings of ``{"params": ..., "opt": ...}`` on ``mesh``."""
    pshard = steps.param_shardings(mcfg, mesh)
    return {"params": pshard, "opt": steps.opt_shardings(pshard, mesh)}


def make_train_state(mcfg: ModelConfig, mesh=None, seed: int = 0, *,
                     device: str | torch.device = "cuda"):
    """(params, opt_state): the port's own seeded init (torch cannot
    reproduce ``jax.random``), with ``cfg.param_dtype`` master weights and
    float32 moments.  On a mesh, on the mesh's device, each leaf is drawn
    whole, as on one device, and only this rank's shard of it is kept."""
    if mesh is None:
        params = M.init_lm(mcfg, seed=seed, device=device,
                           dtype=getattr(torch, mcfg.param_dtype))
        return params, adamw.init_opt_state(params)
    pshard = flatten(steps.param_shardings(mcfg, mesh))
    params = M.init_lm(
        mcfg, seed=seed, device=mesh.device,
        dtype=getattr(torch, mcfg.param_dtype),
        keep=lambda path, full: pshard["/".join(path)].local(full))
    return params, adamw.init_opt_state(params)


def _restore(ckpt: CheckpointManager, params, opt_state, shardings=None):
    """Newest VERIFIED checkpoint (corrupt steps are skipped, counted, and
    fall back), resharded onto the current mesh with ``shardings``."""
    corrupt = obs_metrics.active_registry().counter("ft.ckpt_corrupt")

    def on_corrupt(step: int) -> None:
        corrupt.inc()
        obs_trace.instant("ft.ckpt_corrupt", step=step)
        print(f"[train] checkpoint step {step} failed verification; "
              f"falling back")

    step, state = ckpt.restore_latest({"params": params, "opt": opt_state},
                                      shardings, on_corrupt=on_corrupt)
    if step is None:
        return 0, params, opt_state
    print(f"[train] resumed from step {step}")
    return step, state["params"], state["opt"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(mcfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
          ocfg: adamw.OptConfig = adamw.OptConfig(), *, mesh=None,
          ft: FTManager | None = None,
          chaos: ChaosEngine | None = None,
          skip_data_steps: Collection[int] = frozenset(),
          on_metrics: Callable[[int, dict[str, Any]], None] | None = None):
    """Run (or resume) training to tcfg.total_steps on ``tcfg.device``.
    Returns the history, the final params and opt state, the step and the
    final loss.

    ``skip_data_steps`` (supervisor-owned) replaces those steps' batches
    with a disjoint deterministic substitute (data step ``s +
    tcfg.total_steps``) — the rollback path for data-dependent non-finite
    losses.  With ``ft`` given, every step heartbeats all workers and
    consults ``ft.decide()``; RESTART/ELASTIC verdicts raise for the
    supervisor to handle.  A step's time ``train.step_s`` is taken after
    the device has finished it.  With ``mesh`` this rank trains its shards
    on the mesh's device (see the module docstring); a rank outside the
    mesh returns at once with ``outside_mesh`` set and no state.
    """
    if mesh is not None and not mesh.contains:
        print(f"[train] rank {mesh.rank} is outside the "
              f"{list(mesh.shape.values())} mesh; leaving the loop")
        return {"history": [], "params": None, "opt_state": None,
                "step": None, "final_loss": float("nan"),
                "outside_mesh": True}
    device = M.resolve_device(tcfg.device) if mesh is None else mesh.device
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
    shardings = None if mesh is None else state_shardings(mcfg, mesh)
    params, opt_state = make_train_state(mcfg, mesh, tcfg.seed, device=device)
    start_step, params, opt_state = _restore(ckpt, params, opt_state,
                                             shardings)
    writer = mesh is None or mesh.rank == 0
    graphs = tcfg.step_graphs
    if graphs is None:
        graphs = device.type == "cuda"
    graph = None
    if graphs and mesh is None:
        graph = TrainGraph(params, opt_state, cfg=mcfg, opt_cfg=ocfg,
                           num_microbatches=tcfg.num_microbatches,
                           device=device)

    history: Any = (deque(maxlen=tcfg.log_history)
                    if tcfg.log_history is not None else [])
    reg = obs_metrics.active_registry()
    m_steps = reg.counter("train.steps")
    h_step = reg.histogram("train.step_s")
    g_loss = reg.gauge("train.loss")
    skip = frozenset(skip_data_steps)
    try:
        for step in range(start_step, tcfg.total_steps):
            if chaos is not None:
                chaos.on_step_start(step)      # may raise WorkerKilled
            substituted = step in skip
            data_step = step + tcfg.total_steps if substituted else step
            batch = batch_for_model(mcfg, dcfg, data_step, device=device)
            t0 = time.perf_counter()
            with obs_trace.span("train.step", step=step) as sp:
                if graph is not None:
                    metrics = graph.step(batch)
                elif mesh is None:
                    params, opt_state, metrics = steps.train_step(
                        params, opt_state, batch, cfg=mcfg, opt_cfg=ocfg,
                        num_microbatches=tcfg.num_microbatches)
                else:
                    params, opt_state, metrics = steps.sharded_train_step(
                        params, opt_state, batch, cfg=mcfg, opt_cfg=ocfg,
                        mesh=mesh, shardings=shardings["params"],
                        num_microbatches=tcfg.num_microbatches)
                _sync(device)
                metrics = {k: v if isinstance(v, str) else float(v)
                           for k, v in metrics.items()}
                sp["loss"] = metrics.get("loss")
            dt = time.perf_counter() - t0
            loss = metrics.get("loss", 0.0)
            if chaos is not None:
                loss = chaos.filter_loss(step, loss, substituted=substituted)
                metrics["loss"] = loss
            if not math.isfinite(loss):
                # crashing later on garbage weights is strictly worse; the
                # supervisor rolls back to the last checkpoint and skips
                # this step's batch
                raise NonFiniteLossError(step, loss)
            metrics["step_s"] = dt
            m_steps.inc()
            h_step.record(dt)
            g_loss.set(loss)
            if ft is not None:
                _heartbeat_and_decide(ft, chaos, step, dt, mesh)
            if writer and ((step + 1) % tcfg.log_every == 0
                           or step == start_step):
                print(f"[train] step {step + 1}/{tcfg.total_steps} "
                      f"loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms")
            if on_metrics:
                on_metrics(step, metrics)
            history.append(metrics)
            if (step + 1) % tcfg.ckpt_every == 0 \
                    or step + 1 == tcfg.total_steps:
                with obs_trace.span("train.checkpoint", step=step + 1) as sp:
                    sp["blocked_s"] = ckpt.save(
                        step + 1, {"params": params, "opt": opt_state},
                        blocking=not tcfg.async_ckpt,
                        shardings=shardings)
                if chaos is not None and chaos.wants_corrupt(step + 1):
                    ckpt.wait()            # the fault hits a finished write
                    if writer:
                        chaos.corrupt_checkpoint(tcfg.ckpt_dir, step + 1)
    finally:
        ckpt.wait()
    history = list(history)
    return {"history": history, "params": params, "opt_state": opt_state,
            "step": tcfg.total_steps,
            "final_loss": history[-1]["loss"] if history else float("nan")}


def _heartbeat_and_decide(ft: FTManager, chaos: ChaosEngine | None,
                          step: int, dt: float, mesh=None) -> None:
    """Feed this step's heartbeats (all workers — the loop stands in for
    the fleet) and act on the coordinator's verdict.  On a mesh the first
    rank's manager decides and broadcasts its verdict, and the others adopt
    it: ranks that read their own clocks would disagree on time-outs and
    stragglers, and then wait in different collectives."""
    for w in ft.workers:
        if chaos is not None and chaos.heartbeat_suppressed(w):
            continue
        factor = chaos.latency_factor(w, step) if chaos is not None else 1.0
        ft.heartbeat(w, dt * factor)
    if mesh is None or mesh.size == 1:
        action, info = ft.decide()
    else:
        verdict = None
        if mesh.rank == 0:
            try:
                verdict = ft.decide()
            except RuntimeError as e:   # the budget, raised on every rank
                verdict = (None, {"error": str(e)})
        action, info = mesh.broadcast_object(verdict)
        if action is None:
            raise RuntimeError(info["error"])
        if mesh.rank != 0:
            ft.adopt(action, info)
    if action is Action.RESTART_FROM_CKPT:
        raise RestartRequired(f"worker(s) {info.get('dead')} died at "
                              f"step {step}", step=step, info=info)
    if action is Action.ELASTIC_RESHAPE:
        raise ReshapeRequired(f"capacity lost at step {step}; reshaping "
                              f"to {info['mesh'][0]}",
                              target=info["mesh"], step=step, info=info)
    if info.get("stragglers"):
        obs_metrics.active_registry().counter("ft.stragglers").inc(
            len(info["stragglers"]))
        obs_trace.instant("ft.straggler", step=step,
                          workers=len(info["stragglers"]))
