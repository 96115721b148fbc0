"""Plain PyTorch version of the paged KV gather (the port of
``repro/kernels/paged_attention/ref.py``): a dense take along the page axis."""

from __future__ import annotations

import torch


def paged_gather(store: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """store: (P, ps, H, D); page_table: (B, n) int32 -> (B, n, ps, H, D).

    ``out[b, i] = store[page_table[b, i]]``; reshaped to (B, n*ps, H, D) it
    is the per-slot contiguous KV view the attention math reads."""
    return store[page_table.long()]
