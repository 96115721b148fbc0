"""The dense decoder block (pre-norm attention and MLP with residuals), the
Mamba-2 block (pre-norm SSM mixer with a residual) and the Zamba-2 hybrid
group (mamba blocks, then the one shared decoder block)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import modules as nn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


def decoder_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                  causal: bool = True,
                  pos_offset: int | torch.Tensor = 0,
                  cache: dict[str, Any] | None = None,
                  return_cache: bool = False):
    """-> (x, new_cache); ``new_cache`` is None unless ``cache`` is given or
    ``return_cache`` is set."""
    h = nn.rmsnorm_apply(p["ln1"], x)
    a, new_cache = attn_mod.attention(p["attn"], h, cfg, causal=causal,
                                      pos_offset=pos_offset, cache=cache,
                                      return_cache=return_cache)
    x = x + a
    h2 = nn.rmsnorm_apply(p["ln2"], x)
    return x + mlp_mod.mlp(p["ffn"], h2, cfg), new_cache


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
                return_state: bool = False):
    """The mamba blocks ``stacked`` on axis 0, in turn -> (x, states).
    Decode passes their ``states`` (conv/SSD, stacked on axis 0) and they
    are advanced in place; prefill (``return_state``) gets the new states
    stacked; otherwise ``states`` stays None."""
    layers = layer_views(stacked)
    views = [None] * len(layers) if states is None else layer_views(states)
    new = []
    for lp, st in zip(layers, views):
        x, ns = mamba_block(lp, x, cfg, state=st, return_state=return_state)
        if st is not None:
            for k, v in ns.items():
                st[k].copy_(v)
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
                            return_state=return_state)
    if return_state and attn_cache is None:          # prefill
        if apply_attn:
            x, cache = decoder_block(shared, x, cfg, causal=True,
                                     return_cache=True)
        else:
            cache = attn_mod.prefill_kv(
                shared["attn"], nn.rmsnorm_apply(shared["ln1"], x), cfg)
        return x, states, cache
    if apply_attn:
        x, attn_cache = decoder_block(shared, x, cfg, causal=True,
                                      pos_offset=pos_offset, cache=attn_cache)
    return x, states, attn_cache
