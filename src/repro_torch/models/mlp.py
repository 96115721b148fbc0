"""Dense MLP variants: SwiGLU / GeGLU / GELU.

Under tensor-parallel serving the hidden dim is this rank's share
(``cfg.d_ff`` of its local config), so the down projection is a partial
sum, reduced over the ranks (``tp_allreduce``, the identity off a mesh)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.tp import tp_allreduce
from repro_torch.models import modules as nn
from repro_torch.models.config import ModelConfig


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = nn.dense(p["w_gate"], x, dt)
        gate = F.silu(gate) if cfg.mlp_type == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = gate * nn.dense(p["w_up"], x, dt)
    elif cfg.mlp_type == "gelu":
        h = F.gelu(nn.dense(p["w_up"], x, dt), approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return tp_allreduce(nn.dense(p["w_down"], h, dt))
