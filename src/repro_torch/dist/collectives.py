"""Compressed collectives: per-block symmetric int8 quantization (the port of
``repro.dist.collectives``).

Scheme: flatten, pad to a multiple of ``block``, one float32 scale per block
(symmetric, scale = max|block| / 127), so the round-trip error of every
element is at most scale/2 = max|block|/254.  Zero blocks quantize to exact
zeros, and rounding is half to even (``torch.round``, as ``jnp.round``).
:func:`compressed_all_reduce` is the counterpart of ``compressed_psum``:
every rank quantizes its partial sum, the int8 payloads and scales are
exchanged, and every rank dequantizes and sums them in rank order, so the
result is the same on every rank, and it comes back in the INPUT dtype (a
bf16 activation stays bf16).

Non-finite contract: quantization SANITIZES.  A NaN element quantizes to 0
and ±Inf clamps to the block's finite-magnitude extreme; scales are
computed over finite elements only, so one overflowed element never
poisons its block's other ``block - 1`` elements, nor through the sum every
rank's copy.

The exchange is the reference's: all-gather the int8 payload and the
scales (one collective here, each rank's scales' bytes after its
payload), so each rank receives ~(N-1)·|x| int8 bytes (plus 4 bytes of scale
per block) on an N-way group, against ~2·(N-1)/N·|x|·4 bytes for a ring
float32 all-reduce.  It only wins on small groups (N <= 8); larger ones
need a quantized reduce-scatter, which is not implemented.  ``all_gather``
runs on NCCL, and on gloo with CPU tensors and with CUDA tensors (two ranks
sharing one H100, torch 2.11: ``tools/gloo_probe.py``), though gloo's
documentation lists only ``broadcast``, ``all_reduce`` and ``barrier`` for
CUDA tensors.

:func:`settled` runs any collective so that its CPU tensors are freed on
the caller's thread (see its docstring); the port's seams, gathers and
re-lays run through it.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

QMAX = 127.0
#: the seconds :func:`settled` waits at most for a process group to let go
SETTLE_S = 1.0


def settled(op, *tensors: torch.Tensor) -> None:
    """Run ``op()``, a collective over ``tensors``, and return once the
    process group has let go of them.  Gloo's worker thread drops its
    references a little after the collective completes, so a tensor
    whose last reference it held would be freed on that thread at a moment
    its timing decides, and a rank's peak memory with it; waiting (at most
    ``SETTLE_S``) frees each where its caller drops it, as one thread
    would.  CUDA tensors are not waited for: their memory is the caching
    allocator's, not a count held to the dry run exactly."""
    held = [t._use_count() for t in tensors]
    op()
    if any(t.device.type != "cpu" for t in tensors):
        return
    end = time.monotonic() + SETTLE_S
    while any(t._use_count() > n for t, n in zip(tensors, held)) \
            and time.monotonic() < end:
        time.sleep(0)


def quantize_int8(x: torch.Tensor, block: int = 64):
    """x (any shape) -> (q int8 (nblocks, block), scales f32 (nblocks,), pad).

    ``pad`` is the number of zero elements appended so the flat size
    divides ``block``; callers pass it on to :func:`dequantize_int8`.
    Non-finite inputs are sanitized per element (see the module docstring).
    """
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block).float()
    finite = torch.isfinite(blocks)
    amax = torch.where(finite, blocks.abs(), 0.0).amax(dim=1)
    scales = torch.where(amax > 0, amax, 1.0) / QMAX
    # NaN -> 0 first (clamp propagates NaN), then ±Inf -> ±amax
    blocks = torch.where(torch.isnan(blocks), 0.0, blocks)
    blocks = torch.clamp(blocks, -amax[:, None], amax[:, None])
    q = torch.clamp(torch.round(blocks / scales[:, None]), -QMAX, QMAX)
    return q.to(torch.int8), scales, pad


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, pad: int, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (up to the per-block error bound)."""
    flat = (q.float() * scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compressed_all_reduce(x: torch.Tensor, group=None,
                          block: int = 64) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` with int8-compressed traffic;
    the result is the same on every rank and has ``x``'s dtype."""
    q, scales, pad = quantize_int8(x, block)
    n = dist.get_world_size(group)
    # one all-gather of each rank's payload with its scales' bytes behind
    # it (the reference's two gathers' bytes, in one collective)
    nq = q.numel()
    wire = torch.cat([q.reshape(-1), scales.view(torch.int8)])
    got = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(got, wire, group=group)

    def part(r: int) -> torch.Tensor:
        return got[r][:nq].view(q.shape).float() \
            * got[r][nq:].view(torch.float32)[:, None]

    # summed in rank order on every rank: the same float32 result everywhere
    total = part(0)
    for r in range(1, n):
        total = total + part(r)
    total = total.reshape(-1)
    if pad:
        total = total[:-pad]
    return total.reshape(x.shape).to(x.dtype)


def compression_ratio(x: torch.Tensor, block: int = 64) -> float:
    """Wire-bytes ratio of the compressed representation vs fp32."""
    n = x.numel()
    nblocks = -(-n // block)
    return (nblocks * block * 1 + nblocks * 4) / (n * 4)
