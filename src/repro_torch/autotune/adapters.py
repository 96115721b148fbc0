"""Live-workload adapters: observed dispatch shapes -> tunable targets.

The recorder aggregates serving traffic into :class:`WorkloadKey`\\ s — a
(kind, prompt_len, batch, dtype) per distinct dispatch shape.  Each kernel
takes its own argument shapes, so someone has to say "a prefill of 16-token
prompts at batch 1 under THIS model is the causal flash-attention kernel at
(1, hq, 64, hd)".  That someone is this module: given the serving model and
engine configuration, :func:`serve_targets` maps each live key to the SIP
kernel the engine's hot path actually dispatches for it, with a
``make_args`` matching the shape the kernel is called at.

The target's signature must be the one the serving path resolves, or a
promotion lands on a signature nothing serves.  Two things make the port's
differ from the key as the JAX package reads it:

* the dtype: a bfloat16 model's key says ``"bfloat16"``, which numpy has
  no type for.  Arguments are drawn as float32 numpy (the JAX package's
  draws, as ``InputSpec.sample`` makes them) and the workload's ``dtypes``
  round them to bfloat16 when they become tensors;
* the length: the port's causal flash runs at lengths padded to a
  multiple of ``SEQ_TILE`` (``kernels/flash_attention/kernel.py::padded``),
  so a key's prompt length maps to that padded ``sq``.

Keys with no tunable kernel behind them (submit records, decode without the
paged gather) map to None and the service skips them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.registry import Workload
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pg_ops
from repro_torch.models.config import ModelConfig
from repro_torch.obs.recorder import WorkloadKey
from repro_torch.serve.engine import ServeConfig


@dataclasses.dataclass(frozen=True)
class TuneTarget:
    """One tunable (kernel, workload) pair derived from a live key."""

    kernel: str
    workload: Workload


def _attn_args(b: int, hq: int, hkv: int, s: int, d: int):
    def make_args(rng: np.random.Generator) -> Sequence[np.ndarray]:
        q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
        k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        return [q, k, v]
    return make_args


def _gather_args(p: int, ps: int, h: int, d: int, b: int, n: int):
    def make_args(rng: np.random.Generator) -> Sequence[np.ndarray]:
        store = rng.standard_normal((p, ps, h, d)).astype(np.float32)
        pt = rng.integers(0, p, (b, n)).astype(np.int32)
        return [store, pt]
    return make_args


def padded_len(s: int) -> int:
    """The length a causal flash call of ``s`` rows runs at."""
    return -(-s // fa_kernel.SEQ_TILE) * fa_kernel.SEQ_TILE


def serve_targets(cfg: ModelConfig, scfg: ServeConfig
                  ) -> Callable[[WorkloadKey], TuneTarget | None]:
    """The adapter for a serving deployment: live key -> tunable target.

    * ``prefill`` keys -> the flash-attention variant the model's prefill
      resolves (causal, ``cfg.window``), at the observed batch, the padded
      prompt length and the model's head geometry.  (A chunked prefill
      records the chunk length at batch 1; the engine reads those chunks
      through the gather, but the key cannot tell them from a whole
      prompt of that length, so they map here too, as in the JAX package.)
    * ``decode`` keys -> the ``paged_gather`` kernel (paged serving's
      page-table-indirect cache read) at the pool geometry the engine
      allocates: a store of ``(num_pages, page_size, n_kv_heads, hd)`` and
      page tables of ``(capacity, ceil(max_len / page_size))``;
      contiguous-mode decode has no SIP kernel on its path, so those keys
      are skipped.
    * anything else (``submit`` bookkeeping) -> None.
    """
    hd = cfg.hd
    ps = scfg.page_size
    n_slot_pages = -(-scfg.max_len // ps)
    num_pages = (scfg.num_pages if scfg.num_pages is not None
                 else scfg.capacity * n_slot_pages + 1)

    def target_for(key: WorkloadKey) -> TuneTarget | None:
        if key.kind == "prefill" and key.prompt_len >= 1:
            name = fa_ops.ensure_registered(causal=True, window=cfg.window)
            make_args = _attn_args(key.batch, cfg.n_heads, cfg.n_kv_heads,
                                   padded_len(key.prompt_len), hd)
            return TuneTarget(name, Workload(
                name=key.name, make_args=make_args, suites=("live",),
                dtypes=(key.dtype,) * 3))
        if key.kind == "decode" and scfg.paged:
            make_args = _gather_args(num_pages, ps, cfg.n_kv_heads, hd,
                                     key.batch, n_slot_pages)
            return TuneTarget(pg_ops.NAME, Workload(
                name=key.name, make_args=make_args, suites=("live",),
                dtypes=(key.dtype, "int32")))
        return None

    return target_for
