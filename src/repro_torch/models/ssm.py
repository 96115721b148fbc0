"""Mamba-2 mixer block (SSD core), with O(1)-state decode — the port of
``repro/models/ssm.py``.

A fused input projection producing (z, x, B, C, dt), a short causal
depthwise conv over (x, B, C), the chunked SSD scan (kernels/ssd), a gated
RMSNorm, and the output projection.  Under ``cfg.use_pallas`` (serving)
prefill (no incoming state) runs the SSD's intra-chunk term on the CUDA
kernel through the registry (``ssd.ops.ssd_chunked_kernel``; its plain
version on CPU tensors), and so does a continuation of S > 1 from a state;
without it (training: the kernel has no backward) both take the plain
``ssd.ops.ssd_chunked_plain`` over the same padded chunks.  Decode
(S = 1) stays in plain torch, one recurrent step per token.

Under a training scope that cuts the ``"ssm"`` seam (``dist.tp.training``:
sharded training, and the GSPMD serving path's split) a rank of ``n``
along ``"model"`` computes its ``h/n`` heads only: its heads' ``z``,
``x`` and ``dt`` columns of ``in_proj`` and every ``B`` and ``C`` column
(one group: every head reads them), the conv over its heads' ``x``
channels and ``B``, ``C``, the SSD over its heads, the gated RMSNorm
with its channels' sum of squares summed over the ranks
(``tp.sum_over_model``), and its rows of ``out_proj``, whose partial sum
the ``"ssm"`` seam sums (``tp.tp_allreduce``).  ``A_log``, ``D``,
``dt_bias``, ``norm`` and ``out_proj`` lie cut by heads, so a rank's
block is its heads'; ``in_proj`` and the conv's leaves (and the conv
state) lie in contiguous blocks of their concatenated columns, which
:func:`~repro_torch.dist.partition.relay` re-lays at use.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import partition, tp
from repro_torch.kernels.ssd import chunked
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import modules as nn
from repro_torch.models.config import ModelConfig

#: leaves read in float32 by the reference (``ssm.py:218-220``, ``:245``):
#: stored float32 here, whatever the compute dtype
F32_LEAVES = ("conv_b", "A_log", "D", "dt_bias", "norm")
#: the reference's init (``init_mamba``): a normal scale, or a constant
INIT = {"in_proj": "d", "conv_w": "conv", "out_proj": "d_inner",
        "conv_b": 0.0, "A_log": 0.0, "D": 1.0, "dt_bias": 0.0, "norm": 1.0}


def mixer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's mixer leaves (the reference's ``init_mamba`` tree)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {"in_proj": (d, 2 * di + 2 * n + h),        # z, x, B, C, dt
            "conv_w": (cfg.conv_width, conv_ch), "conv_b": (conv_ch,),
            "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm": (di,),
            "out_proj": (di, d)}


def init_scale(cfg: ModelConfig, name: str) -> float:
    """The normal init's scale of a projection leaf."""
    return {"d": cfg.d_model, "conv": cfg.conv_width,
            "d_inner": cfg.d_inner}[INIT[name]] ** -0.5


def _split(di: int, n: int, h: int, zxbcdt: torch.Tensor):
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt heads, not {h}")
    return z, xbc, dt


@functools.lru_cache(maxsize=64)
def head_columns(cfg: ModelConfig, n: int) -> tuple[tuple, tuple]:
    """What each of ``n`` ranks that split the heads reads: (its
    ``in_proj`` columns, its conv channels), as sorted ``(start, stop)``
    ranges of the ``[z | x | B | C | dt]`` and ``[x | B | C]`` layouts,
    one tuple of ranges a rank: its heads' ``z``, ``x`` and ``dt``, and
    every ``B`` and ``C``."""
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, hl = di // n, h // n
    bc = 2 * di + 2 * ns
    cols = tuple(((r * dl, (r + 1) * dl), (di + r * dl, di + (r + 1) * dl),
                  (2 * di, bc), (bc + r * hl, bc + (r + 1) * hl))
                 for r in range(n))
    chans = tuple(((r * dl, (r + 1) * dl), (di, di + 2 * ns))
                  for r in range(n))
    return cols, chans


def _causal_conv(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (W, C)."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def mamba(p, x: torch.Tensor, cfg: ModelConfig, *,
          state: dict[str, Any] | None = None, return_state: bool = False):
    """x: (B, S, d).  ``state`` = {'conv': (B, W-1, C), 'ssd': (B,H,N,P)}
    enables continuation (decode uses S=1 via :func:`mamba_step`).  Under
    a scope that cuts ``"ssm"`` (module docstring) the rank computes its
    heads: the state is its blocks (the conv's laid as ``conv_w`` is: a
    contiguous block, or whole) and so is the new state, and the output
    is summed over the ranks."""
    bt, s, _ = x.shape
    n, pdim = cfg.ssm_state, cfg.ssm_headdim
    dt_ = x.dtype
    wc = cfg.conv_width - 1
    part = tp.model_part("ssm")
    in_proj, conv_w, conv_b = (p[k].to(dt_)
                               for k in ("in_proj", "conv_w", "conv_b"))
    if part is None:
        di, h = cfg.d_inner, cfg.ssm_heads
    else:
        rank, ways = part
        di, h = cfg.d_inner // ways, cfg.ssm_heads // ways
        group = tp.model_group("ssm")
        cols, chans = head_columns(cfg, ways)
        conv_ch = cfg.d_inner + 2 * n
        blocked = conv_w.shape[-1] != conv_ch
        in_proj = partition.relay(in_proj, -1,
                                  cfg.d_inner + conv_ch + cfg.ssm_heads,
                                  cols, rank, ways, group)
        conv_w, conv_b = (partition.relay(t, -1, conv_ch, chans, rank, ways,
                                          group) for t in (conv_w, conv_b))
        if state is not None:
            state = {**state, "conv": partition.relay(
                state["conv"], -1, conv_ch, chans, rank, ways, group)}
        x = tp.tp_enter(x, "ssm")

    zxbcdt = nn.dense(in_proj, x)
    z, xbc, dtp = _split(di, n, h, zxbcdt)
    if state is not None:
        xbc_in = torch.cat([state["conv"].to(dt_), xbc], dim=1)
        conv_out = _causal_conv(conv_w, conv_b, xbc_in)[:, wc:]
    else:
        conv_out = _causal_conv(conv_w, conv_b, xbc)
    xs = conv_out[..., :di].reshape(bt, s, h, pdim)
    B = conv_out[..., di:di + n]
    C = conv_out[..., di + n:]

    dt_act = F.softplus(dtp.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if state is not None and s == 1:
        # decode: ssd_chunked at S = 1 is exactly one recurrent step
        ssd_state, y1 = chunked.ssd_step(state["ssd"], xs[:, 0],
                                         dt_act[:, 0], A, B[:, 0], C[:, 0],
                                         p["D"])
        y = y1[:, None]
    else:
        # prefill, or a continuation of S > 1: the intra-chunk term on the
        # CUDA kernel (registry) under use_pallas; a ragged S is padded, not
        # cut into tiny chunks (``ssd.ops.padded_chunk``)
        ssd_fn = ssd_ops.ssd_chunked_kernel if cfg.use_pallas \
            else ssd_ops.ssd_chunked_plain
        y, ssd_state = ssd_fn(
            xs, dt_act, A, B, C, p["D"], chunk=cfg.ssm_chunk,
            init_state=None if state is None else state["ssd"],
            return_state=True)
    y = y.reshape(bt, s, di).to(dt_)
    if part is None:
        y = nn.rmsnorm_apply(p["norm"], y * F.silu(z))
    else:
        y = _gated_norm(p["norm"], y * F.silu(z), cfg.d_inner)
    out = tp.tp_allreduce(nn.dense(p["out_proj"], y, dt_), "ssm")
    if return_state or state is not None:
        hist = xbc if state is None else xbc_in
        deficit = wc - hist.shape[1]
        if deficit > 0:
            hist = F.pad(hist, (0, 0, deficit, 0))
        conv = hist[:, hist.shape[1] - wc:]
        if part is not None:
            conv = partition.relay_back(conv, -1, conv_ch, chans, rank, ways,
                                        group, blocked)
        return out, {"conv": conv, "ssd": ssd_state}
    return out


def _gated_norm(gamma: torch.Tensor, x: torch.Tensor, width: int,
                eps: float = 1e-6) -> torch.Tensor:
    """``nn.rmsnorm_apply`` over ``width`` channels of which ``x`` holds
    this rank's: its squares' sum summed over the ranks."""
    xf = x.float()
    ms = tp.sum_over_model((xf * xf).sum(dim=-1, keepdim=True), "ssm") \
        / width
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def mamba_step(p, x_t: torch.Tensor, cfg: ModelConfig,
               state: dict[str, Any]):
    """One decode token.  x_t: (B, d)."""
    out, new_state = mamba(p, x_t[:, None, :], cfg, state=state)
    return out[:, 0], new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: str | torch.device = "cpu"):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }
