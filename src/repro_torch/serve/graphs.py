"""The continuous engine's decode step, captured: the port of the reference's
jitted, cache-donating decode dispatch (``repro/serve/engine.py``, the
``jax.jit(..., donate_argnums=...)`` of each engine's step functions).

A :class:`StepGraph` belongs to one one-device :class:`~repro_torch.serve.
engine.ContinuousEngine`.  It owns the step's static inputs, ``tokens``
(capacity,) int32 and, for a paged engine, ``pt`` (capacity, n_slot_pages)
int32 and ``active`` (capacity,) bool, and a static ``logits`` output
(capacity, vocab).  The engine's cache tree is static already: every decode
path of the model writes its caches in place (``models/model.py``), so the
step reads and writes the same storage on every call, as the reference's
donated buffers are.

On a CUDA device the first :meth:`StepGraph.replay` after construction or
:meth:`StepGraph.drop` captures the step (:meth:`StepGraph._capture`): the
step runs once, eagerly, on a side stream (one a device, shared by every
capture; this warm-up builds and loads every kernel it launches, since
neither nvcc nor ``cuModuleLoadData`` may run inside a capture, and its
logits are that call's), and then the step is captured on that stream into
a ``torch.cuda.CUDAGraph`` (``capture_error_mode="thread_local"``, so an
autotune thread's CUDA calls on its own stream neither break the capture
nor land in the graph's memory pool, which takes only the capturing
stream's allocations).  A capture runs nothing.  Every later call copies
the host arrays into the static inputs through pinned host buffers and
replays the graph.  A failed capture or replay raises; there is no return
to eager dispatch.

The kernels' launches inside a replay do not pass through their Python
wrappers, whose counters would then stop counting.  The capture records on
its own thread what each launch would have counted
(``kernels.recording_launches``), and every replay credits it
(``kernels.credit_launches``), so every count is of launches that ran.

On the CPU (a caller that asked for it) the same static-buffer step runs
eagerly on every call: the inputs are copied into the static buffers and
the step's logits into the static output.

The engine drops the graph on every schedule swap (``ContinuousEngine.
_make_dispatchers``): a registry kernel resolves its schedule on the host,
when the step is captured, so the next decode re-captures and launches the
promoted schedule.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Iterator

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

_CHECK_SYNCS = contextvars.ContextVar("check_syncs", default=False)
#: device index -> the one stream every capture on it warms up and captures
#: on: cuBLAS keeps a workspace for each stream it has run on, for the life
#: of the process, so a new stream a capture would hold 32 MiB more each
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


@contextlib.contextmanager
def checking_syncs() -> Iterator[None]:
    """Inside the block, a capture's warm-up step and the capture itself run
    under ``torch.cuda.set_sync_debug_mode("error")``: any op of the step
    that waits for the device, or copies pageable memory to it, raises.
    The mode is process-wide, so use it where no other thread runs CUDA
    work (a test, a smoke run)."""
    token = _CHECK_SYNCS.set(True)
    try:
        yield
    finally:
        _CHECK_SYNCS.reset(token)


@contextlib.contextmanager
def _sync_debug() -> Iterator[None]:
    if not _CHECK_SYNCS.get():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class StepGraph:
    """One engine's lockstep decode step over static inputs (module
    docstring).  ``caches`` is the engine's cache tree, which the step
    advances in place; ``n_slot_pages`` makes the step paged.

    ``captures`` counts the captures (on the CPU: the steps run after
    construction or a drop), ``replays`` the replays of a captured step,
    ``credits`` the launches each replay adds."""

    def __init__(self, params, caches, cfg: ModelConfig, capacity: int, *,
                 device: torch.device, n_slot_pages: int | None = None):
        self.params, self.caches, self.cfg = params, caches, cfg
        self.device = device
        self.cuda = device.type == "cuda"
        self.tokens = torch.zeros(capacity, dtype=torch.int32, device=device)
        self.pt = self.active = None
        if n_slot_pages is not None:
            self.pt = torch.zeros((capacity, n_slot_pages), dtype=torch.int32,
                                  device=device)
            self.active = torch.zeros(capacity, dtype=torch.bool,
                                      device=device)
        self.logits = torch.empty(
            (capacity, params["lm_head"].shape[-1]),
            dtype=M.compute_dtype(cfg), device=device)
        self._host = {name: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=self.cuda)
                      for name, t in self._inputs().items()}
        self._copied: torch.cuda.Event | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.credits: collections.Counter = collections.Counter()
        self.captures = self.replays = 0
        self._stale = True

    def _inputs(self) -> dict[str, torch.Tensor]:
        return {name: t for name, t in (("tokens", self.tokens),
                                        ("pt", self.pt),
                                        ("active", self.active))
                if t is not None}

    def drop(self) -> None:
        """Forget the captured step (its memory pool goes with it): the
        next :meth:`replay` captures anew (on the CPU: counts a capture)."""
        self.graph = None
        self.credits = collections.Counter()
        self._stale = True

    def replay(self, tokens: np.ndarray, pt: np.ndarray | None = None,
               active: np.ndarray | None = None) -> torch.Tensor:
        """One decode step on ``tokens`` (capacity,) (and a paged engine's
        page tables ``pt`` and ``active`` rows) -> the static logits
        (capacity, vocab), valid until the next call."""
        self._stage({"tokens": tokens, "pt": pt, "active": active})
        if self.graph is not None:
            self.graph.replay()
            kernels.credit_launches(self.credits)
            self.replays += 1
        elif self.cuda:
            self._capture()
        else:
            self.captures += self._stale
            self._stale = False
            self._step()
        return self.logits

    def pool_bytes(self) -> int | None:
        """Bytes of the device segments the captured graph's private memory
        pool holds (None before a capture)."""
        if self.graph is None:
            return None
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # ------------------------------------------------------------ internals
    def _stage(self, arrays: dict[str, np.ndarray | None]) -> None:
        """Copy the host arrays into the static inputs: through the pinned
        buffers on a CUDA device, once the last call's copies are done."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, static in self._inputs().items():
            host = self._host[name]
            host.numpy()[...] = arrays[name]
            static.copy_(host, non_blocking=self.cuda)
        if self.cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _step(self) -> None:
        logits, _ = M.decode_step(self.params, self.caches, self.tokens,
                                  self.cfg, pt=self.pt, active=self.active)
        self.logits.copy_(logits)

    def _capture(self) -> None:
        """This call's step, eagerly on the side stream (the warm-up: every
        kernel built and loaded), then the step captured on it, which runs
        nothing and records the launches each replay credits."""
        main = torch.cuda.current_stream(self.device)
        index = main.device.index
        side = _CAPTURE_STREAMS.get(index)
        if side is None:
            side = _CAPTURE_STREAMS[index] = torch.cuda.Stream(main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), _sync_debug():
            self._step()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with kernels.recording_launches() as launched:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                with _sync_debug():
                    self._step()
        self.graph, self.credits = graph, launched
        self.captures += 1
