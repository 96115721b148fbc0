"""Plain PyTorch version of fused RMSNorm (the port of
``repro/kernels/rmsnorm/ref.py``)."""

from __future__ import annotations

import torch

EPS = 1e-6


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(ms + eps)) * gamma.float()
    return y.to(x.dtype)
