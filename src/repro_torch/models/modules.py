"""Primitives shared by the model layers: the dense product and RMSNorm.

The JAX package's ``Param``/logical-axes machinery has no counterpart here:
params are nested dicts of tensors with the same tree and leaf names as
``repro``'s ``nn.unwrap(init_lm(...))``.
"""

from __future__ import annotations

import torch


def dense(w: torch.Tensor, x: torch.Tensor, dtype=None) -> torch.Tensor:
    return x @ (w.to(dtype) if dtype is not None else w)


def rmsnorm_apply(gamma: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to ``x``'s dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * gamma.float()
    return y.to(x.dtype)
