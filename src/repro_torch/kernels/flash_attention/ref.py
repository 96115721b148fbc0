"""Plain PyTorch version of the fused attention kernel (the port of
``repro/kernels/flash_attention/ref.py``): GQA by repeating kv heads,
causal and sliding-window masks on right-aligned rows, finite masking."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Returns (B, Hq, Sq, D)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    qf = q.float() * (d ** -0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # right-aligned
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l.clamp_min(1e-30)
    return o.to(q.dtype)
