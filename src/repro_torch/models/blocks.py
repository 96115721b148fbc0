"""The dense decoder block (pre-norm attention and MLP with residuals) and
the Mamba-2 block (pre-norm SSM mixer with a residual)."""

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
