"""Rank functions of the port's sharded-training CPU tests.

``repro_torch.dist.spawn.run`` starts every rank in a fresh process that
imports its function by name, so the functions live here, in a module that
imports neither JAX nor the JAX package: each rank then pays only for
``torch`` and ``repro_torch``.  Arguments and results are numpy arrays and
plain Python values; only job rank 0 returns arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import partition, pipeline
from repro_torch.ft import ChaosEngine, FaultPlan, FTConfig, FTManager
from repro_torch.ft import Supervisor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw
from repro_torch.train import loop

AXES = ("data", "model")


def _full(tree, shardings) -> dict:
    """The whole of a sharded tree, as numpy, on every rank."""
    return {k: shardings[k].gather(v).numpy()
            for k, v in flatten(tree).items()}


def _shard(params_np, cfg, mesh):
    """(params, opt_state, param shardings): this rank's shards of
    ``params_np`` and of fresh moments."""
    pshard = steps.param_shardings(cfg, mesh)
    full = params_from_numpy(params_np, cfg, device="cpu",
                             dtype=torch.float32)
    params = partition.local_tree(full, pshard)
    return params, adamw.init_opt_state(params), pshard


def train_parity(rank: int, cases: list[dict]) -> list[dict]:
    """Each case: a config, its numpy params, a numpy batch, an OptConfig,
    a microbatch count, a mesh shape and the rule overrides (or None) that
    lay the state out.  One sharded step on that mesh (ranks past it sit
    out) -> on rank 0 the whole params and moments after the step, the
    metrics and the loss mode; every rank's loss."""
    out, meshes = [], {}
    for case in cases:
        if case["mesh"] not in meshes:      # groups are made collectively
            meshes[case["mesh"]] = mesh_lib.mesh_for(case["mesh"], AXES)
        mesh = meshes[case["mesh"]]
        if not mesh.contains:
            out.append(None)
            continue
        cfg = case["cfg"]
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        with partition.mesh_rules(mesh, case["rules"]):
            params, opt, pshard = _shard(case["params"], cfg, mesh)
            params, opt, m = steps.sharded_train_step(
                params, opt, batch, cfg=cfg, opt_cfg=case["ocfg"], mesh=mesh,
                shardings=pshard, num_microbatches=case["micro"])
        res = {"loss": float(m["loss"]), "mode": m["mode"],
               "grad_norm": float(m["grad_norm"]),
               "local_shapes": {k: tuple(v.shape)
                                for k, v in flatten(params).items()}}
        full = {"params": _full(params, flatten(pshard)),
                "mu": _full(opt["mu"], flatten(pshard)),
                "nu": _full(opt["nu"], flatten(pshard))}
        if rank == 0:
            res.update(full)
        out.append(res)
    return out


def reshard(rank: int, cfg, params_np, ckpt_dir: str,
            meshes: list[tuple]) -> dict:
    """Save ``params_np`` and moments sharded on a (2, 2) mesh (moments set
    to the params and their squares), then restore that step on each of
    ``meshes`` -> on rank 0 each restore gathered whole, with its local
    shapes."""
    mesh = mesh_lib.mesh_for((2, 2), AXES)
    params, opt, pshard = _shard(params_np, cfg, mesh)
    for p, m, n in zip(adamw.leaves(params), adamw.leaves(opt["mu"]),
                       adamw.leaves(opt["nu"])):
        m.copy_(p)
        n.copy_(p * p)
    opt["step"].fill_(3)
    mgr = CheckpointManager(ckpt_dir)
    state = {"params": params, "opt": opt}
    shards = {"params": pshard, "opt": steps.opt_shardings(pshard, mesh)}
    mgr.save(7, state, blocking=False, shardings=shards)
    mgr.wait()
    out = {"saved_local": {k: tuple(v.shape)
                           for k, v in flatten(params).items()}}
    for shape in meshes:
        other = mesh_lib.mesh_for(shape, AXES)
        sh = loop.state_shardings(cfg, other)
        template = {"params": M.map_params(
            lambda _, s: torch.zeros(s.local_shape), sh["params"])}
        template["opt"] = adamw.init_opt_state(template["params"])
        got = mgr.restore(7, template, sh)
        full = _full(got, flatten(sh))
        if rank == 0:
            out[str(shape)] = {
                "full": full,
                "local": {k: tuple(v.shape) for k, v in
                          flatten(got["params"]).items()}}
    return out if rank == 0 else {}


def elastic(rank: int, cfg, dcfg: DataConfig, ocfg, steps_: int, every: int,
            ckpt_base: str, ckpt_chaos: str, tick: float) -> dict:
    """The uninterrupted (2, 2) run, then the supervised run that loses
    worker 1 of 2 (2 chips each) at step 4 for good and reshapes onto
    (1, 2).  Both start from the step-0 checkpoint already in their
    directories.  -> this rank's results of both runs."""
    base = loop.train(cfg, dcfg, loop.TrainConfig(
        total_steps=steps_, ckpt_every=every, ckpt_dir=ckpt_base,
        log_every=1000, device="cpu"), ocfg,
        mesh=mesh_lib.mesh_for((2, 2), AXES))
    ladder = (((2, 2), AXES), ((1, 2), AXES))
    t = [0.0]
    ft = FTManager(n_workers=2, cfg=FTConfig(
        heartbeat_timeout_s=1.0, chips_per_worker=2, mesh_ladder=ladder),
        clock=lambda: t[0])
    beat = ft.heartbeat

    def ticking(w, lat):        # a clock that moves one tick a heartbeat
        t[0] += tick
        beat(w, lat)

    ft.heartbeat = ticking
    chaos = ChaosEngine(FaultPlan.parse("kill@4:w1:perm", n_workers=2))
    tcfg = loop.TrainConfig(total_steps=steps_, ckpt_every=every,
                            ckpt_dir=ckpt_chaos, log_every=1000,
                            device="cpu")
    sup = Supervisor(
        functools.partial(loop.train, cfg, dcfg, tcfg, ocfg, ft=ft,
                          chaos=chaos),
        ft=ft, chaos=chaos, mesh=mesh_lib.mesh_for((2, 2), AXES),
        mesh_factory=lambda target: mesh_lib.mesh_for(*target),
        sleep=lambda s: None)
    res = sup.run()
    s = res["supervisor"]
    return {"base_loss": base["final_loss"], "base_step": base["step"],
            "base_modes": sorted({h["mode"] for h in base["history"]}),
            "step": res["step"], "final_loss": res["final_loss"],
            "outside_mesh": bool(res.get("outside_mesh")),
            "events": [{k: v for k, v in e.items() if k != "attempt"}
                       for e in s["events"]],
            "final_mesh": list(s["final_mesh"][0])}


def _mlp_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipelines(rank: int, cases: list[dict]) -> list[dict]:
    """Each case: stacked numpy stage params ``w`` (S, D, D) and ``b`` (S,
    D), an input, a microbatch count and a (stage, dp) mesh.  The pipelined
    forward and the gradient of mean(y ** 2) -> the output and, summed over
    the stage ranks, each stage's gradient (on rank 0)."""
    out = []
    for case in cases:
        mesh = mesh_lib.mesh_for(case["mesh"], ("stage", "dp"))
        params = {k: torch.tensor(case[k], requires_grad=True)
                  for k in ("w", "b")}
        y = pipeline.pipeline_apply(_mlp_stage, params,
                                    torch.as_tensor(case["x"]), mesh=mesh,
                                    axis="stage", n_micro=case["n_micro"])
        torch.mean(y ** 2).backward()
        # each stage rank holds its own stage's gradient; along "dp" the
        # ranks repeat one another
        grads = {}
        for k, v in params.items():
            g = v.grad.clone()
            dist.all_reduce(g, group=mesh.group("stage"))
            grads[k] = g.numpy()
        out.append({"y": y.detach().numpy(), "grads": grads}
                   if rank == 0 else {})
    return out


def qwen_block_pipeline(rank: int, cfg, params_np, x: np.ndarray,
                        n_micro: int) -> dict:
    """Two stages, one decoder block each, of ``cfg`` (2 layers) over a
    (2,) ``("stage",)`` mesh, against the blocks applied in sequence on
    this rank: forward and the gradient of each block's params."""
    mesh = mesh_lib.mesh_for((2,), ("stage",))
    params = params_from_numpy(params_np, cfg, device="cpu",
                               dtype=torch.float32)["blocks"]

    def stage(p, h):
        return blocks.decoder_block(p, h, cfg, causal=True)[0]

    live = M.map_params(lambda _, t: t.clone().requires_grad_(), params)
    y = pipeline.pipeline_apply(stage, live, torch.as_tensor(x), mesh=mesh,
                                axis="stage", n_micro=n_micro)
    torch.mean(y ** 2).backward()

    def summed(_, t):           # each rank holds its own stage's gradient
        g = t.grad.clone()
        dist.all_reduce(g, group=mesh.group("stage"))
        return g
    got = params_to_numpy(M.map_params(summed, live))
    seq = M.map_params(lambda _, t: t.clone().requires_grad_(), params)
    h = torch.as_tensor(x)
    for lp in blocks.layer_views(seq):
        h = stage(lp, h)
    torch.mean(h ** 2).backward()
    want = params_to_numpy(M.map_params(lambda _, t: t.grad, seq))
    return {"y": y.detach().numpy(), "want_y": h.detach().numpy(),
            "grads": got, "want_grads": want, "stage": mesh.coord("stage")}
