"""Captured steps: the port of the reference's jitted, cache-donating
dispatch (``repro/serve/engine.py``, the ``jax.jit(..., donate_argnums=...)``
of each engine's step functions, and ``repro/train/loop.py``'s jitted train
step).

:class:`CapturedStep` is what every captured step shares.  It owns the
step's static inputs, which the host stages through pinned host buffers
(:meth:`CapturedStep._stage`), and its static outputs; the state the step
advances (an engine's cache tree, a trainer's params and moments) is static
already, since every such path writes it in place, so the step reads and
writes the same storage on every call, as the reference's donated buffers
are.

On a CUDA device the first :meth:`CapturedStep.run` after construction or
:meth:`CapturedStep.drop` captures the step (:meth:`CapturedStep._capture`):
the step runs once, eagerly, on a side stream (one a device, shared by
every capture; this warm-up builds and loads every kernel it launches,
since neither nvcc nor ``cuModuleLoadData`` may run inside a capture, and
its outputs are that call's), and then the step is captured on that stream
into a ``torch.cuda.CUDAGraph`` (``capture_error_mode="thread_local"``, so
an autotune thread's CUDA calls on its own stream neither break the
capture nor land in the graph's memory pool, which takes only the
capturing stream's allocations; ``torch.cuda.graph`` syncs the device and
releases the allocator's cached blocks, the warm-up's among them, before
it begins).  A capture runs nothing.  Every later call stages the inputs
and replays the graph.  A failed capture or replay raises; there is no
return to eager dispatch.

The kernels' launches inside a replay do not pass through their Python
wrappers, whose counters would then stop counting.  The capture records on
its own thread what each launch would have counted
(``kernels.recording_launches``), and every replay credits it
(``kernels.credit_launches``), so every count is of launches that ran.

On the CPU (a caller that asked for it) the same static-buffer step runs
eagerly on every call: the inputs are copied into the static buffers and
the step's outputs into the static ones.

The serving steps here:

* :class:`StepGraph`, a one-device engine's lockstep decode step;
* :class:`PrefillStep`, a whole-prompt prefill of one group with its insert
  into the engine's caches, and :class:`ChunkStep`, one chunked-prefill
  step, both kept by the engine's :class:`PrefillGraphs`, which captures a
  shape on its :data:`CAPTURE_AT`-th sighting and shares one memory pool
  among them.

``repro_torch.train.graphs.TrainGraph`` is the one-device train step.  The
engine drops its graphs on every schedule swap (``ContinuousEngine.
_make_dispatchers``): a registry kernel resolves its schedule on the host,
when the step is captured, so the next call re-captures and launches the
promoted schedule.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Any, Callable, Iterator

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


def pool_bytes(pool) -> int:
    """Bytes of the device segments that the graph memory pool ``pool``
    (a ``CUDAGraph.pool()`` or ``torch.cuda.graph_pool_handle()``) holds."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class CapturedStep:
    """A step over static inputs and outputs, captured on its first
    :meth:`run` on a CUDA device and replayed on every later one (module
    docstring).  A subclass gives :meth:`_step`, the step itself, and
    :meth:`_inputs`, the static inputs :meth:`_stage` fills from host
    arrays.  ``pool`` is a graph memory pool to capture into (shared with
    other steps that never run at once); None gives the graph its own.

    ``captures`` counts the captures (on the CPU: the steps run after
    construction or a drop), ``replays`` the replays of a captured step,
    ``credits`` the launches each replay adds."""

    def __init__(self, device: torch.device, pool=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.pool = pool
        self._host: dict[str, torch.Tensor] = {}
        self._copied: torch.cuda.Event | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.credits: collections.Counter = collections.Counter()
        self.captures = self.replays = 0
        self._stale = True

    def _inputs(self) -> dict[str, torch.Tensor]:
        """The static inputs :meth:`_stage` copies host arrays into."""
        return {}

    def _step(self) -> None:
        raise NotImplementedError

    def drop(self) -> None:
        """Forget the captured step (its memory goes back to its pool): the
        next :meth:`run` captures anew (on the CPU: counts a capture)."""
        self.graph = None
        self.credits = collections.Counter()
        self._stale = True

    def run(self) -> None:
        """The step over the static inputs as they stand: replayed, captured
        (on a CUDA device, the first time), or eager (on the CPU)."""
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

    def pool_bytes(self) -> int | None:
        """Bytes of the device segments the captured graph's memory pool
        holds (None before a capture); a shared pool's whole."""
        if self.graph is None:
            return None
        return pool_bytes(self.graph.pool())

    # ------------------------------------------------------------ internals
    def _stage(self, arrays: dict[str, Any]) -> None:
        """Copy the host arrays into the static inputs: through pinned
        buffers on a CUDA device, once the last call's copies are done."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, static in self._inputs().items():
            host = self._host.get(name)
            if host is None:
                host = self._host[name] = torch.empty(
                    static.shape, dtype=static.dtype, pin_memory=self.cuda)
            host.numpy()[...] = arrays[name]
            static.copy_(host, non_blocking=self.cuda)
        if self.cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()

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
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                with _sync_debug():
                    self._step()
        self.graph, self.credits = graph, launched
        self.captures += 1


class StepGraph(CapturedStep):
    """One engine's lockstep decode step over static inputs: ``tokens``
    (capacity,) int32 and, for a paged engine (``n_slot_pages``), ``pt``
    (capacity, n_slot_pages) int32 and ``active`` (capacity,) bool, and a
    static ``logits`` output (capacity, vocab).  ``caches`` is the engine's
    cache tree, which the step advances in place.  The graph has a memory
    pool of its own."""

    def __init__(self, params, caches, cfg: ModelConfig, capacity: int, *,
                 device: torch.device, n_slot_pages: int | None = None):
        super().__init__(device)
        self.params, self.caches, self.cfg = params, caches, cfg
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

    def _inputs(self) -> dict[str, torch.Tensor]:
        return {name: t for name, t in (("tokens", self.tokens),
                                        ("pt", self.pt),
                                        ("active", self.active))
                if t is not None}

    def replay(self, tokens: np.ndarray, pt: np.ndarray | None = None,
               active: np.ndarray | None = None) -> torch.Tensor:
        """One decode step on ``tokens`` (capacity,) (and a paged engine's
        page tables ``pt`` and ``active`` rows) -> the static logits
        (capacity, vocab), valid until the next call."""
        self._stage({"tokens": tokens, "pt": pt, "active": active})
        self.run()
        return self.logits

    def _step(self) -> None:
        logits, _ = M.decode_step(self.params, self.caches, self.tokens,
                                  self.cfg, pt=self.pt, active=self.active)
        self.logits.copy_(logits)


def _static(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device buffer of host array ``a``'s shape and dtype."""
    return torch.empty(a.shape, dtype=torch.from_numpy(np.asarray(a)).dtype,
                       device=device)


class PrefillStep(CapturedStep):
    """A whole-prompt prefill of one group of G same-length prompts with
    its insert, over static inputs: ``tokens`` (G, S) int32, the group's
    extra inputs (a VLM's ``embeds``, an encoder-decoder's ``enc_embeds``),
    ``slots`` (G,) int64 and, for a paged engine, ``page_rows`` (G, n_pg)
    int32.  ``M.prefill`` builds the group's caches at ``max_len``, which
    ``M.insert_pages`` or ``M.insert_slots`` write into the engine's caches
    in place; the last positions' logits are copied into the static
    ``logits`` (G, vocab), allocated outside the graph's pool.  ``arrays``
    is the first call's host arrays, which give the shapes."""

    def __init__(self, params, caches, cfg: ModelConfig, max_len: int,
                 arrays: dict[str, np.ndarray], *, device: torch.device,
                 pool=None):
        super().__init__(device, pool)
        self.params, self.caches, self.cfg = params, caches, cfg
        self.max_len = max_len
        self.statics = {k: _static(a, device) for k, a in arrays.items()}
        g = arrays["tokens"].shape[0]
        self.logits = torch.empty((g, params["lm_head"].shape[-1]),
                                  dtype=M.compute_dtype(cfg), device=device)

    def _inputs(self) -> dict[str, torch.Tensor]:
        return self.statics

    def _step(self) -> None:
        s = self.statics
        inputs = {k: v for k, v in s.items()
                  if k not in ("slots", "page_rows")}
        logits, grp = M.prefill(self.params, inputs, self.cfg,
                                max_len=self.max_len)
        if "page_rows" in s:
            M.insert_pages(self.caches, grp, s["slots"], s["page_rows"])
        else:
            M.insert_slots(self.caches, grp, s["slots"])
        self.logits.copy_(logits)


class ChunkStep(CapturedStep):
    """One chunked-prefill step over static inputs: ``tokens`` (1, chunk)
    int32 (or ``embeds`` (1, chunk, d) beside them), the slot's page-table
    row ``pt`` (1, n_pages) int32, and ``slot`` (int64) and ``n_valid``
    (int32) as 0-dim tensors; the last valid position's logits are copied
    into the static ``logits`` (1, vocab).  The slot's lengths are read and
    written on the device (``M.prefill_chunk``), so one graph serves every
    slot and every final chunk's valid length."""

    def __init__(self, params, caches, cfg: ModelConfig,
                 arrays: dict[str, np.ndarray], *, device: torch.device,
                 pool=None):
        super().__init__(device, pool)
        self.params, self.caches, self.cfg = params, caches, cfg
        self.statics = {k: _static(a, device) for k, a in arrays.items()}
        self.logits = torch.empty((1, params["lm_head"].shape[-1]),
                                  dtype=M.compute_dtype(cfg), device=device)

    def _inputs(self) -> dict[str, torch.Tensor]:
        return self.statics

    def _step(self) -> None:
        s = self.statics
        last, _ = M.prefill_chunk(self.params, self.caches, s["tokens"],
                                  s["pt"], s["slot"], s["n_valid"], self.cfg,
                                  embeds=s.get("embeds"))
        self.logits.copy_(last)


#: a shape is captured on this sighting; the ones before it run eagerly.
#: The rule is ski rental: a sighting run eagerly forgoes what a replay
#: would save, s, and a capture costs C more than an eager dispatch, so a
#: shape is captured on sighting ceil(C / s) + 1, once the eager sightings
#: have forgone about what the capture costs; whatever the traffic, no
#: shape then costs more than twice what the best choice in hindsight
#: would have.  On an H100, C / s is 1.6 for qwen3-1.7b's whole-prompt
#: prefills and 2.6 for mamba2-2.7b's (medians over the shapes of
#: ``chip_smoke._waves``' ``break_even`` in four runs; a capture's cost is
#: host work and ranges 1.0-6.0 and 1.4-11.8 times a replay's saving):
#: the larger's ceiling, 3, and one.
CAPTURE_AT = 4


class PrefillGraphs:
    """One one-device engine's captured prefill and chunk steps, by key.

    :meth:`run` counts each sighting of a key.  Before the
    :data:`CAPTURE_AT`-th it returns None, and the engine dispatches
    eagerly.  At that sighting the step is built and captured (its warm-up
    is the call itself), and every later sighting replays it.  The steps
    share one graph memory pool: they run one at a time on the engine's
    stream and each copies its outputs out of the pool, so the pool holds
    the largest step's temporaries rather than their sum.  Every step is
    kept until :meth:`drop`, as the reference keeps every jitted shape:
    what a step holds outside the pool is its static inputs and logits.
    :meth:`drop` (a schedule swap) drops them all and the pool with them;
    sightings are kept, so a key seen before re-captures at once.

    ``captures`` and ``replays`` count over the engine's life (on the CPU,
    where the steps run eagerly, what a card would have captured and
    replayed), into the ``serve.prefill_captures`` and
    ``serve.prefill_replays`` counters of ``obs``; ``credited`` sums the
    launches the replays credited."""

    def __init__(self, device: torch.device, obs):
        self.device = device
        self.steps: dict[tuple, CapturedStep] = {}
        self.sightings: collections.Counter = collections.Counter()
        self._pool = None
        self.credited: collections.Counter = collections.Counter()
        self._captures = obs.counter("serve.prefill_captures")
        self._replays = obs.counter("serve.prefill_replays")

    @property
    def captures(self) -> int:
        return int(self._captures.value)

    @property
    def replays(self) -> int:
        return int(self._replays.value)

    def run(self, key: tuple, make: Callable[[Any], CapturedStep],
            arrays: dict[str, Any]) -> torch.Tensor | None:
        """This sighting of ``key``: None (dispatch eagerly), or the static
        logits of the step ``make(pool)`` builds, run on ``arrays`` (valid
        until the next call)."""
        self.sightings[key] += 1
        if self.sightings[key] < CAPTURE_AT:
            return None
        step = self.steps.get(key)
        fresh = step is None
        if fresh:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            step = self.steps[key] = make(self._pool)
        step._stage(arrays)
        step.run()
        if fresh:
            self._captures.inc()
        else:
            self._replays.inc()
            self.credited.update(step.credits)
        return step.logits

    def pool_bytes(self) -> int | None:
        """Bytes the shared pool's device segments hold (None before the
        first capture)."""
        if self._pool is None or not self.steps:
            return None
        return pool_bytes(self._pool)

    def drop(self) -> None:
        """Drop every step and the pool: the next sighting of a key seen
        before captures anew."""
        for step in self.steps.values():
            step.drop()
        self.steps.clear()
        self._pool = None
