"""Plain PyTorch version of the paged KV gather (the port of
``repro/kernels/paged_attention/ref.py``): a dense take along the page axis,
with the page-id contract of the reference's kernel."""

from __future__ import annotations

import torch


def page_ids(page_table: torch.Tensor, num_pages: int) -> torch.Tensor:
    """The pages that ``page_table``'s ids read, as the reference's Pallas
    kernel (``repro/kernels/paged_attention/kernel.py:65``) reads them: an
    id in [-P, 0) wraps to id + P, and then every id is clamped into
    [0, P - 1], so an id outside [-P, P) reads the first or the last page.
    (The reference's oracle, ``jnp.take``, gives NaN rows there instead.)"""
    ids = page_table.long()
    ids = torch.where(ids < 0, ids + num_pages, ids)
    return ids.clamp(0, num_pages - 1)


def paged_gather(store: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """store: (P, ps, H, D); page_table: (B, n) int32 -> (B, n, ps, H, D).

    ``out[b, i] = store[page_table[b, i]]``, the ids mapped by
    :func:`page_ids`; reshaped to (B, n*ps, H, D) it is the per-slot
    contiguous KV view the attention math reads."""
    return store[page_ids(page_table, store.shape[0])]
