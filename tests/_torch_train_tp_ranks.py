"""Rank functions of the port's compute-sharded training tests
(tests/test_torch_train_tp.py).

``repro_torch.dist.spawn.run`` starts every rank in a fresh process that
imports its function by name, so they live here, in a module that imports
neither JAX nor the JAX package.  Arguments and results are numpy arrays
and plain Python values.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.dist import partition, tp
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw

AXES = ("data", "model")


def xent(rank: int, cases: list[dict]) -> list[dict]:
    """Each case: float32 logits (B, S, V), labels, a mask (or None), a
    ``logits_microbatch`` and a mesh shape (1, n).  The vocab-parallel
    token losses of this rank's V/n columns (``M.token_losses`` inside a
    training scope that cuts the vocab) and the gradient of their masked
    mean with respect to those columns -> the loss, the token losses and
    this rank's column block of the gradient (None for a rank outside the
    mesh)."""
    out, meshes = [], {}
    for case in cases:
        if case["mesh"] not in meshes:      # groups are made collectively
            meshes[case["mesh"]] = mesh_lib.mesh_for(case["mesh"], AXES)
        mesh = meshes[case["mesh"]]
        if not mesh.contains:
            out.append(None)
            continue
        n, r = mesh.shape["model"], mesh.coord("model")
        logits = torch.from_numpy(case["logits"])
        cols = logits.shape[-1] // n
        mine = logits[..., r * cols:(r + 1) * cols].clone().requires_grad_()
        labels = torch.from_numpy(case["labels"]).long()
        cfg = case["cfg"]
        with tp.training(mesh.group("model"), r, n, {"vocab"}):
            tl = M.token_losses(mine, labels, cfg)
            mask = case["mask"]
            loss = tl.mean() if mask is None else \
                (tl * torch.from_numpy(mask)).sum() / float(mask.sum())
            loss.backward()
        out.append({"loss": float(loss.detach()),
                    "token_losses": tl.detach().numpy(),
                    "grad": mine.grad.numpy()})
    return out


def counted_steps(rank: int, cases: list[dict]) -> list[dict]:
    """Each case: a config, its numpy params, a numpy batch and a mesh
    shape.  One ``sharded_train_step`` counted by the dry run's
    ``StepCounter`` -> the counts, the loss, the seams its split cuts, the
    leaves it gathers whole and its local config, and on job rank 0 the
    first moment gathered whole."""
    out, meshes = [], {}
    for case in cases:
        if case["mesh"] not in meshes:
            meshes[case["mesh"]] = mesh_lib.mesh_for(case["mesh"], AXES)
        mesh = meshes[case["mesh"]]
        if not mesh.contains:
            out.append(None)
            continue
        cfg = case["cfg"]
        pshard = steps.param_shardings(cfg, mesh)
        params = partition.local_tree(
            params_from_numpy(case["params"], cfg, device="cpu",
                              dtype=torch.float32), pshard)
        opt = adamw.init_opt_state(params)
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        box = {}

        def step():
            box["m"] = steps.sharded_train_step(
                params, opt, batch, cfg=cfg, opt_cfg=adamw.OptConfig(),
                mesh=mesh, shardings=pshard)[2]
        counts = dryrun.count(step, (params, opt, batch), mesh)
        split = steps.model_split(cfg, mesh, pshard)
        res = {"counts": counts, "loss": float(box["m"]["loss"]),
               "cut": sorted(split.cut) if split else [],
               "whole": sorted("/".join(p) for p in split.whole)
               if split else [],
               "local_cfg": dataclasses.asdict(split.cfg) if split else None}
        mu = {k: flatten(pshard)[k].gather(v).numpy()
              for k, v in flatten(opt["mu"]).items()}
        if rank == 0:
            res["mu"] = mu
        out.append(res)
    return out
