"""AdamW with a warmup-then-cosine schedule, global-norm clipping and
float32 moments (the port of ``repro/optim/adamw.py``).

The math and its order are the reference's: clip the gradients by their
global norm, advance ``step``, bias-correct both moments, then a decoupled
weight decay on every leaf.  The schedule and the bias corrections are
float32 scalars on the params' device, as the reference computes them, so
no step reads a value back to the host.  Where the reference returns new
trees (and the train step donates the old ones), :func:`adamw_update`
updates params and state in place: a full-width model keeps one float32
copy of each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.model import map_params

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree: Any) -> list[torch.Tensor]:
    """A nested dict's tensors in sorted key order, the order of
    ``jax.tree.leaves``: the global norm sums the leaves as the reference
    does."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32 on its device:
    linear warmup, then a cosine from ``peak_lr`` to ``min_lr_ratio`` of
    it over ``decay_steps``."""
    step = step.to(F32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Any) -> dict[str, Any]:
    """Float32 zero moments beside each param, and an int32 ``step``."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = leaves(params)[0].device
    return {"mu": map_params(zeros, params), "nu": map_params(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled to at most ``max_norm`` in float32, their norm).  A
    float32 gradient is scaled in place: ``grads`` is consumed.  ``norm``,
    when given, is the norm to clip by (a shard's gradients are clipped by
    the whole gradient's)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(_, g):
        return g.mul_(scale) if g.dtype == F32 else g.to(F32) * scale
    return map_params(clip, grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: dict[str, Any], params: Any,
                 cfg: OptConfig, *, norm: torch.Tensor | None = None):
    """One AdamW step -> (params, state, metrics), params and state updated
    in place and returned.  ``grads`` is consumed: a float32 gradient is
    clipped in place.  ``norm`` is the global norm to clip by where
    ``grads`` is a shard of the gradient (default: ``grads``' own)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    state["step"].add_(1)
    step = state["step"]
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(F32)
    bc2 = 1 - b2 ** step.to(F32)
    for p, g, m, n in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                          leaves(state["nu"])):
        m.mul_(b1).add_((1 - b1) * g)
        n.mul_(b2).add_((1 - b2) * g * g)
        pf = p if p.dtype == F32 else p.to(F32)
        delta = (m / bc1).div_(torch.sqrt(n / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * pf).mul_(lr)
        if p is pf:
            p.sub_(delta)
        else:
            p.copy_(pf - delta)
    return params, state, {"lr": lr, "grad_norm": gnorm}
