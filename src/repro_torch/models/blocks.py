"""The decoder block (pre-norm attention, an encoder-decoder's
cross-attention, and an MLP or MoE, with residuals; an encoder block is
one run bidirectionally), the Mamba-2 block (pre-norm SSM mixer with a
residual) and the Zamba-2 hybrid group (mamba blocks, then the one shared
decoder block); :func:`remat`, the per-layer rematerialisation the
training forward wraps each layer in."""

from __future__ import annotations

import contextvars
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.dist import partition
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import modules as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


#: the products that ``remat_policy="dots"`` saves (the reference's
#: ``checkpoint_dots``); every other op of a layer is recomputed
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default,
                     torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn``, one layer (or a hybrid group) of the training forward, as
    the reference's ``_maybe_remat`` wraps its scan body: with grad
    enabled and ``cfg.remat`` set, under ``torch.utils.checkpoint`` (non
    reentrant), which keeps only the layer's inputs and runs it again in
    the backward (policy ``"full"``), or keeps the outputs of its matrix
    products too and runs the rest again (``"dots"``).  ``"none"``, remat
    off, and a call without grad (serving) run ``fn`` as it is.  The run
    again is the whole layer (no early stop: its FLOPs are one more
    forward), and it sees the context variables of the first (the
    tensor-parallel seams' scope): autograd may run it on another
    thread."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    extra = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
        if cfg.remat_policy == "dots" else {})

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        scope = contextvars.copy_context()
        with set_checkpoint_early_stop(False):
            return checkpoint(lambda *a, **k: scope.copy().run(fn, *a, **k),
                              *args, use_reentrant=False,
                              preserve_rng_state=False, **extra, **kwargs)
    return run


def zero_aux() -> dict[str, float]:
    """A dense block's aux losses (the reference's ``ZERO_AUX``), as
    Python zeros: no device work on the serving path."""
    return dict.fromkeys(moe_mod.AUX_KEYS, 0.0)


def _ffn(p, x: torch.Tensor, cfg: ModelConfig, dropless: bool):
    if cfg.family == "moe":
        return moe_mod.moe(p["ffn"], x, cfg, dropless=dropless)
    return mlp_mod.mlp(p["ffn"], x, cfg), zero_aux()


def decoder_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                  causal: bool = True,
                  pos_offset: int | torch.Tensor = 0,
                  cache: dict[str, Any] | None = None,
                  return_cache: bool = False,
                  cross_kv: dict[str, torch.Tensor] | None = None):
    """-> (x, aux, new_cache); ``new_cache`` is None unless ``cache`` is
    given or ``return_cache`` is set.  An MoE layer is dropless when it
    reads a cache (decode, chunked prefill), as the reference's is.
    ``cross_kv`` (``attention.encode_kv``) adds ``ln_x`` and the ``xattn``
    cross-attention after the self-attention."""
    h = nn.rmsnorm_apply(p["ln1"], x)
    a, new_cache = attn_mod.attention(p["attn"], h, cfg, causal=causal,
                                      pos_offset=pos_offset, cache=cache,
                                      return_cache=return_cache)
    x = x + a
    if cross_kv is not None:
        hx = nn.rmsnorm_apply(p["ln_x"], x)
        x = x + attn_mod.cross_attention(p["xattn"], hx, cross_kv, cfg)
    h2 = nn.rmsnorm_apply(p["ln2"], x)
    y, aux = _ffn(p, h2, cfg, dropless=cache is not None)
    return x + y, aux, new_cache


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                return_state: bool = False):
    """-> (x, new_state); ``new_state`` is None unless ``state`` is given or
    ``return_state`` is set."""
    h = nn.rmsnorm_apply(p["ln"], x)
    if state is not None or return_state:
        y, new_state = ssm_mod.mamba(p["mixer"], h, cfg, state=state,
                                     return_state=True)
        return x + y, new_state
    return x + ssm_mod.mamba(p["mixer"], h, cfg), None


def layer_views(stacked: dict[str, Any]) -> list[dict[str, Any]]:
    """Per-layer views of a tree of params or states stacked on axis 0:
    one ``unbind`` per leaf, then tuple lookups."""
    def unbind(tree):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    per_leaf = unbind(stacked)
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(per_leaf, i) for i in range(first.shape[0])]


def mamba_stack(stacked, x: torch.Tensor, cfg: ModelConfig, *, states=None,
                return_state: bool = False, remat_each: bool = False,
                path: tuple[str, ...] = ("blocks",),
                state_path: tuple[str, ...] = ()):
    """The mamba blocks ``stacked`` on axis 0, in turn -> (x, states).
    Decode passes their ``states`` (conv/SSD, stacked on axis 0) and they
    are advanced in place; prefill (``return_state``) gets the new states
    stacked; otherwise ``states`` stays None.  ``remat_each`` runs each
    block under :func:`remat` (the training forward).  ``path`` and
    ``state_path`` (default: the root of the caches, an ssm model's) name
    the params and states in their trees, for ``dist.partition``'s
    layer-by-layer hooks."""
    layers = layer_views(stacked)
    views = [None] * len(layers) if states is None else layer_views(states)
    block = remat(mamba_block, cfg) if remat_each else mamba_block
    new = []
    for lp, st in zip(layers, views):
        full = None if st is None else partition.whole_cache(st, *state_path)
        x, ns = block(partition.whole(lp, *path), x, cfg, state=full,
                      return_state=return_state)
        if st is not None:
            partition.write_back(st, ns, *state_path)
        elif ns is not None:
            new.append(ns)
    if new:
        states = {k: torch.stack([ns[k] for ns in new]) for k in new[0]}
    return x, states


def hybrid_group(gp, shared, x: torch.Tensor, cfg: ModelConfig,
                 apply_attn: bool, *, states=None, attn_cache=None,
                 return_state: bool = False,
                 pos_offset: int | torch.Tensor = 0):
    """``cfg.hybrid_group`` mamba blocks (``gp``: their params stacked on
    axis 0; see :func:`mamba_stack` for ``states`` and ``return_state``),
    then the shared decoder block ``shared`` when ``apply_attn`` -> (x,
    states, attn_cache).

    Prefill (``return_state``) returns the shared block's K/V cache for
    every group, as the reference does: an off group's is the projection
    of its input alone (``attention.prefill_kv``), with no attention or MLP
    run.  Decode (``states`` and ``attn_cache`` given) leaves an off
    group's cache, its ``len`` included, untouched."""
    x, states = mamba_stack(gp, x, cfg, states=states,
                            return_state=return_state, path=("groups",),
                            state_path=("mamba",))
    if return_state and attn_cache is None:          # prefill
        if apply_attn:
            x, _, cache = decoder_block(shared, x, cfg, causal=True,
                                        return_cache=True)
        else:
            cache = attn_mod.prefill_kv(
                shared["attn"], nn.rmsnorm_apply(shared["ln1"], x), cfg)
        return x, states, cache
    if apply_attn:
        x, _, attn_cache = decoder_block(shared, x, cfg, causal=True,
                                         pos_offset=pos_offset,
                                         cache=attn_cache)
    return x, states, attn_cache
