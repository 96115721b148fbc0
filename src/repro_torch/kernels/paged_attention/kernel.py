"""Wrapper of the paged-KV gather CUDA kernel (``csrc/paged_gather.cu``).

:func:`paged_gather` keeps the JAX package's layout: store (P, ps, H, D),
page table (B, n) int32 -> (B, n, ps, H, D).  On CPU tensors it runs the
plain version (``ref.paged_gather``); on CUDA tensors it launches the kernel
or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref

SOURCE = "src/repro_torch/csrc/paged_gather.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:65"
DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _check(store: torch.Tensor, page_table: torch.Tensor) -> None:
    if store.device.type != "cuda" or page_table.device != store.device:
        raise ValueError(f"paged_gather: store on {store.device}, page table "
                         f"on {page_table.device}; both must be on one CUDA "
                         f"device")
    if store.dtype not in DTYPES or store.dim() != 4 \
            or not store.is_contiguous():
        raise ValueError(f"paged_gather: store must be a contiguous 4-D "
                         f"tensor of {DTYPES}, got {store.dtype} "
                         f"{tuple(store.shape)} strides {store.stride()}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or not page_table.is_contiguous():
        raise ValueError(f"paged_gather: page table must be a contiguous 2-D "
                         f"int32 tensor, got {page_table.dtype} "
                         f"{tuple(page_table.shape)}")


def paged_gather(store: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """store: (P, ps, H, D); page_table: (B, n) int32 -> (B, n, ps, H, D)."""
    global launches
    if store.device.type == "cpu" and page_table.device.type == "cpu":
        return ref.paged_gather(store, page_table)
    _check(store, page_table)
    b, n = page_table.shape
    out = torch.empty((b, n) + tuple(store.shape[1:]), dtype=store.dtype,
                      device=store.device)
    page_bytes = store[0].numel() * store.element_size()
    lib = _build.load("paged_gather")
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_gather(store.data_ptr(), page_table.data_ptr(),
                               out.data_ptr(), b * n, page_bytes, stream)
    if err:
        raise RuntimeError(f"paged_gather: kernel launch failed with CUDA "
                           f"error {err} (store {tuple(store.shape)}, table "
                           f"{tuple(page_table.shape)})")
    launches += 1
    return out
