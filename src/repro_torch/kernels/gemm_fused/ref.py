"""Plain PyTorch version of fused GEMM + LeakyReLU (the port of
``repro/kernels/gemm_fused/ref.py``, the paper's Table 3 workload)."""

from __future__ import annotations

import torch

ALPHA = 0.01


def gemm_leaky_relu(x: torch.Tensor, w: torch.Tensor,
                    alpha: float = ALPHA) -> torch.Tensor:
    y = x.float() @ w.float()
    y = torch.where(y >= 0, y, alpha * y)
    return y.to(x.dtype)
