"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` keeps the JAX package's layout: q (B, Hq, Sq, D),
k and v (B, Hkv, Skv, D).  On CPU tensors it runs the plain version
(``ref.attention``); on CUDA tensors it launches the kernel or raises.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:179"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}; all must be on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k, v "
                             f"must share one of {list(DTYPES)}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, "
                             f"16-byte aligned 4-D tensor, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not agree")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, DTYPES[q.dtype], int(causal), window or 0, stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    launches += 1
    return out
