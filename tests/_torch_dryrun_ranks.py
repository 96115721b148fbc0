"""Rank functions of the port's dry-run differential (tests/test_torch_dryrun
_ranks.py): real steps on real gloo ranks, counted by the dry run's own
``StepCounter``.

``repro_torch.dist.spawn.run`` starts every rank in a fresh process that
imports its function by name, so they live here, in a module that imports
neither JAX nor the JAX package.  Arguments and results are numpy arrays
and plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.dist import partition
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw

AXES = ("data", "model")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten(tree).values())


def train(rank: int, cfg, params_np, batch_np, shapes) -> list[dict]:
    """One counted ``sharded_train_step`` from ``params_np`` on each mesh
    of ``shapes`` -> this rank's counts, its param bytes and the loss."""
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    out = []
    for shape in shapes:
        mesh = mesh_lib.mesh_for(shape, AXES)
        pshard = steps.param_shardings(cfg, mesh)
        params = partition.local_tree(
            params_from_numpy(params_np, cfg, device="cpu",
                              dtype=torch.float32), pshard)
        opt = adamw.init_opt_state(params)
        box = {}

        def step():
            box["m"] = steps.sharded_train_step(
                params, opt, batch, cfg=cfg, opt_cfg=adamw.OptConfig(),
                mesh=mesh, shardings=pshard)[2]
        counts = dryrun.count(step, (params, opt, batch), mesh)
        out.append({"counts": counts, "param_bytes": _bytes(params),
                    "loss": float(box["m"]["loss"]),
                    "mode": box["m"]["mode"]})
    return out


def serve(rank: int, cfg, params_np, tokens_np, max_len: int,
          shape) -> dict:
    """Counted ``prefill_step`` then ``serve_step`` on a ``shape`` mesh,
    the params and caches this rank's blocks in the GSPMD layout, and the
    same two steps on one device -> the counts, the gathered bytes each
    step's layout recorded, this rank's param bytes and both runs'
    greedy tokens (the prompt's next and the one after)."""
    mesh = mesh_lib.mesh_for(shape, AXES)
    whole = params_from_numpy(params_np, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens_np)}
    rows = steps.serve_rows(cfg, mesh, *tokens_np.shape).local_shape[0]
    layout = steps.serve_layout(cfg, mesh, rows, max_len)
    params = partition.local_tree(whole, layout.params)
    box = {}

    def prefill():
        box["pre"] = steps.prefill_step(params, batch, cfg=cfg,
                                        max_len=max_len, mesh=mesh,
                                        layout=layout)
    pre = dryrun.count(prefill, (params, batch), mesh)
    pre_gathered = layout.gathered_bytes
    logits, caches = box["pre"]
    first = logits.argmax(-1).to(torch.int32)
    layout.gathered_bytes = 0

    def decode():
        box["dec"] = steps.serve_step(params, caches, first, cfg=cfg,
                                      mesh=mesh, layout=layout)
    dec = dryrun.count(decode, (params, caches, first), mesh)
    second = box["dec"][0].argmax(-1)

    one_logits, one_caches = steps.prefill_step(whole, batch, cfg=cfg,
                                                max_len=max_len)
    one_first = one_logits.argmax(-1).to(torch.int32)
    one_second = steps.serve_step(whole, one_caches, one_first,
                                  cfg=cfg)[0].argmax(-1)
    return {"prefill": pre, "decode": dec,
            "prefill_gathered": pre_gathered,
            "decode_gathered": layout.gathered_bytes,
            "param_bytes": _bytes(params),
            "tokens": np.stack([first.numpy(), second.numpy()]),
            "tokens_one_device": np.stack([one_first.numpy(),
                                           one_second.numpy()])}


def train_and_serve(rank: int, cfg, params_np, batch_np, shapes, tokens_np,
                    max_len: int, serve_shape) -> tuple[list[dict], dict]:
    """:func:`train` then :func:`serve` in one job (one start-up)."""
    return (train(rank, cfg, params_np, batch_np, shapes),
            serve(rank, cfg, params_np, tokens_np, max_len, serve_shape))
