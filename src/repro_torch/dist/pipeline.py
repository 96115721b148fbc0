"""GPipe-style pipeline parallelism over one mesh axis (the port of
``repro/dist/pipeline.py``).

``pipeline_apply`` runs S identical stages over M microbatches on the mesh
axis ``axis``, one stage a rank: every step each rank applies its stage to
the activation it holds, then the activations rotate one stage forward.
Stage 0 injects microbatch t at step t; stage S-1 emits microbatch
t-(S-1) at step t; the fill and drain steps where a stage holds no live
microbatch are the schedule's bubble, :func:`bubble_fraction` =
(S-1)/(M+S-1) of the S*(M+S-1) stage-steps.

The schedule is differentiable end to end, as the reference's ``lax.scan``
is: the rotation is a ``torch.autograd.Function`` whose backward rotates
the gradients one stage back (the transpose of the forward rotation), and
the final all-reduce that replicates the last stage's outputs passes each
rank's gradient through unchanged (every rank computes the same loss of the
same replicated output; counted once, it is the gradient of the sequential
stages).  gloo cannot send or receive CUDA tensors (``tools/gloo_probe.py``:
a CUDA ``send`` breaks the connection), so a rotation is one all-gather of
every stage's activation, of which each rank keeps its predecessor's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def bubble_fraction(stages: int, microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(M+S-1)."""
    if stages <= 1:
        return 0.0
    return (stages - 1) / (microbatches + stages - 1)


def _gather(x: torch.Tensor, group, n: int) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Rotate(torch.autograd.Function):
    """Stage i receives stage i-1's activation (stage 0 stage S-1's);
    backward sends each gradient the other way."""

    @staticmethod
    def forward(ctx, y, group, n, idx):
        ctx.group, ctx.n, ctx.idx = group, n, idx
        return _gather(y, group, n)[(idx - 1) % n]

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n)[(ctx.idx + 1) % ctx.n], None, \
            None, None


class _Replicate(torch.autograd.Function):
    """The sum over the group (only the last stage's term is non-zero);
    backward passes the gradient through: the loss of the replicated
    output is one loss, not one a rank."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh, axis: str,
                   n_micro: int) -> torch.Tensor:
    """Apply S stages to ``x`` (batch-leading), pipelined over ``axis`` of
    ``mesh``; every rank of the mesh calls it with the same ``x``.

    ``stage_params``: a nested dict whose leaves have leading dim S =
    ``mesh.shape[axis]``, every stage's, as the reference's stacked params;
    the rank applies its own slice.
    ``stage_fn(params_slice, h) -> h`` must preserve the activation shape.
    ``x.shape[0]`` must divide into ``n_micro`` microbatches.  Mesh axes
    other than ``axis`` replicate.  Returns the outputs of the last stage,
    on every rank."""
    n_stages = mesh.shape[axis]
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    idx = mesh.coord(axis)
    group = mesh.group(axis)

    def own(tree):
        if isinstance(tree, dict):
            return {k: own(v) for k, v in tree.items()}
        if tree.shape[0] != n_stages:
            raise ValueError(f"a stage leaf of leading dim {tree.shape[0]} "
                             f"on a {n_stages}-stage axis")
        return tree[idx]

    p_local = own(stage_params)
    xm = x.reshape((n_micro, batch // n_micro) + x.shape[1:])
    # selections are tensor ops on every rank, never Python branches on the
    # stage: each rank's autograd graph then has the same rotations, and
    # every rank runs every rotation's backward (a collective) in turn
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n_stages - 1, device=x.device)
    state = torch.zeros_like(xm[0])
    outs = []
    n_steps = n_micro + n_stages - 1
    for t in range(n_steps):
        x_t = xm[t] if t < n_micro else torch.zeros_like(xm[0])
        h = torch.where(first, x_t, state)  # stage 0 injects; the rest relay
        y = stage_fn(p_local, h)
        if t >= n_stages - 1:               # microbatch t-(S-1) finishes
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < n_steps - 1:
            state = (_Rotate.apply(y, group, n_stages, idx)
                     if n_stages > 1 else y)
    out = torch.stack(outs)
    if n_stages > 1:
        out = _Replicate.apply(out, group)
    return out.reshape((batch,) + out.shape[2:])
