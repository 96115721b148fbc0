"""The train step (the port of ``repro/launch/steps.py`` ``:27-68``).

``train_step`` does loss + grad (with optional microbatch accumulation in
float32) + AdamW, on the plain versions of the model's kernels
(``use_pallas`` off), as the reference trains: the kernels have no
backward.  The reference's ``prefill_step`` and ``serve_step`` serve only
its dry run, and its shape and sharding helpers (``batch_sds``,
``cache_sds``, the shardings and ``pick_microbatches``) belong to the mesh
paths: both wait for ROADMAP.md Queue 1 item 2.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def loss_and_grads(params, batch, *, cfg: ModelConfig,
                   num_microbatches: int = 1):
    """(metrics, float32 grads) of ``M.loss_fn`` at ``params``.  Gradients
    flow to detached aliases of the leaves (no copy, and the caller's
    tensors are not marked), so params need not require grad.  A leaf the
    loss never reads (an embeddings-mode model's ``embed``) gets a zero
    gradient, as ``jax.grad`` gives it.  With ``num_microbatches > 1`` the
    batch's leading dim is cut into that many slices and their gradients
    and metrics are summed in float32 and divided by the count.  The model
    runs with ``cfg.use_pallas`` off: the kernels' plain, differentiable
    versions."""
    cfg = dataclasses.replace(cfg, use_pallas=False)
    flat = adamw.leaves(params)
    alias = {id(t): t.detach().requires_grad_() for t in flat}
    live = M.map_params(lambda _, t: alias[id(t)], params)
    inputs = [alias[id(t)] for t in flat]

    def one(b):
        with torch.enable_grad():
            total, metrics = M.loss_fn(live, b, cfg)
            grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 if g is None else g.to(torch.float32)
                 for t, g in zip(flat, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    if num_microbatches <= 1:
        metrics, grads = one(batch)
    else:
        n = num_microbatches
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"a batch of {batch['labels'].shape[0]} rows "
                             f"does not split into {n} microbatches")
        parts = [dict(zip(batch, vals)) for vals in
                 zip(*(v.chunk(n, dim=0) for v in batch.values()))]
        metrics, grads = _zero_metrics(flat[0].device), None
        for b in parts:
            m, g = one(b)
            grads = g if grads is None else [a.add_(x)
                                             for a, x in zip(grads, g)]
            metrics = {k: metrics[k] + m[k] for k in metrics}
        grads = [g.div_(n) for g in grads]
        metrics = {k: v / n for k, v in metrics.items()}
    by_leaf = {id(t): g for t, g in zip(flat, grads)}
    return metrics, M.map_params(lambda _, t: by_leaf[id(t)], params)


def train_step(params, opt_state, batch, *, cfg: ModelConfig,
               opt_cfg: adamw.OptConfig, num_microbatches: int = 1):
    """One optimizer step -> (params, opt_state, metrics), params and state
    updated in place; metrics are 0-dim tensors on the params' device
    (``loss``, the aux losses, ``lr``, ``grad_norm``)."""
    metrics, grads = loss_and_grads(params, batch, cfg=cfg,
                                    num_microbatches=num_microbatches)
    params, opt_state, opt_metrics = adamw.adamw_update(
        grads, opt_state, params, opt_cfg)
    return params, opt_state, {**metrics, **opt_metrics}


def _zero_metrics(device: torch.device | str = "cpu") -> dict[str, Any]:
    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": zero(), "aux/load_balance": zero(), "aux/router_z": zero()}

