"""Serving engines over the port's model (the port of ``repro.serve.engine``).

* :class:`Engine` — static batch: one prefill over (B, S) prompts, lockstep
  decode until every row stops.  The differential-correctness reference
  (single-request generation) and the throughput baseline.
* :class:`ContinuousEngine` — continuous batching: a FIFO request queue with
  slot-based admission into a fixed-capacity decode batch.  Admitted
  requests are prefilled at their exact prompt length (same-length arrivals
  as one group), their cache is spliced into free slots, and all occupied
  slots decode in lockstep; finished slots are refilled from the queue
  without stalling the batch.  Per-request stop (eos / max tokens),
  streaming emission via ``on_token``, and a stats surface built on
  :mod:`repro_torch.obs` (counters, gauges, latency histograms, spans).

  With ``ServeConfig(paged=True)`` the per-slot cache segments become a
  paged KV store (:mod:`repro_torch.serve.pages`): attention cache traffic
  goes through per-slot page tables over a shared page pool, admission
  reserves worst-case pages up front (decode never allocates), identical
  prompt prefixes share pages read-only through a content-hashed prefix
  cache, and long prompts optionally prefill in fixed-size chunks
  interleaved with decode (``prefill_chunk``).  The attention families
  page: dense, moe and vlm.  Greedy outputs of a dense model stay
  token-identical to the static engine.  An MoE model's may not, in the
  reference as here: a whole-prompt prefill drops expert copies past
  capacity over all the tokens of its group, while single-request
  generation drops over one prompt's and chunked prefill drops none
  (``models/moe.py``).

A VLM request carries its prompt as precomputed embeddings,
``submit(..., extra={"embeds": (S, d)})``, beside S token ids; prefill and
chunked prefill read the embeddings, decode embeds the sampled tokens, and
such a request never looks up or registers prefix pages (the prefix hash
sees only the token ids).

An ssm model (mamba2) and a hybrid (zamba2) serve through the contiguous
engine: their per-slot conv and SSD states (and a hybrid's shared-block
K/V) are spliced into slots as KV segments are, prompts must cover the
conv's receptive field (``conv_width - 1`` tokens), and paged serving
refuses both families, as the JAX engine does.  So does a sliding-window
model (h2o-danube): its per-slot KV is a ring of ``window`` positions
(``models/model.py``), and paging it raises the reference's error.

The engines run on the device of the params.  Kernels resolve their
schedules from the ``repro_torch.core.registry.schedule_cache`` scope the
engine is built in; a commit to that store mid-flight (an autotune
promotion) is picked up before the next dispatch, restart-free
(:meth:`ContinuousEngine._maybe_refresh_schedules`).  An optional
:class:`~repro_torch.obs.recorder.WorkloadRecorder` logs the live
(shape, dtype, occupancy) mix, record for record as the JAX engine does.
Tensor-parallel serving is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.registry import active_schedule_cache
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.recorder import WorkloadRecorder
from repro_torch.serve.pages import PagePool, PagesExhausted, PrefixCache
from repro_torch.serve.slots import SlotPool

@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256              # per-slot cache length (prompt + new)
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0
    capacity: int = 8               # decode-batch slots (ContinuousEngine)
    # ---- paged KV cache (ContinuousEngine; see repro_torch.serve.pages) --
    paged: bool = False             # page the KV store instead of per-slot
                                    # contiguous max_len segments
    page_size: int = 16             # tokens per cache page
    num_pages: int | None = None    # page budget incl. the trash page;
                                    # None = capacity * ceil(max_len/page_size)
                                    # + 1 (contiguous-equivalent memory)
    prefill_chunk: int | None = None  # split prompts longer than this into
                                    # fixed-size chunks interleaved with
                                    # decode; None = whole-prompt prefill
    prefix_cache: bool = True       # content-hashed prefix sharing (paged)
    admission: str = "queue"        # "queue": wait for pages/slots;
                                    # "reject": submit raises PagesExhausted
                                    # unless the request can start NOW


def _device_of(params) -> torch.device:
    return params["embed"].device


def _sync(device: torch.device) -> None:
    """Wait for the work this thread queued (a dispatch's time ends here):
    the current stream only, so an autotune thread's kernels on its own
    stream never stall serving."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _pick(logits: torch.Tensor, temperature: float,
          gen: torch.Generator) -> torch.Tensor:
    """Greedy argmax, or a draw from softmax(logits / temperature) with the
    engine's generator.  -> (B,) int32."""
    if temperature and temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


class Engine:
    """Static-batch engine: one prefill, lockstep decode, whole batch stops
    together.  The B=1 case is the correctness reference for the
    continuous-batching engine."""

    def __init__(self, params, cfg: ModelConfig,
                 scfg: ServeConfig | None = None):
        check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.scfg = ServeConfig() if scfg is None else scfg
        self.device = _device_of(params)
        self.stats: dict[str, Any] = {"prefill_s": 0.0, "decode_s": 0.0,
                                      "tokens_out": 0}

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 extra_inputs: dict[str, Any] | None = None,
                 eos_id: int | None = None) -> np.ndarray:
        """prompts: (B, S) int32 -> (B, <=max_new_tokens) int32.
        ``extra_inputs`` adds batched model inputs: ``embeds`` (B, S, d)
        for an embeddings-mode (VLM) prompt, left-padded like the
        tokens."""
        b = prompts.shape[0]
        inputs = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                            device=self.device)}
        for k, v in (extra_inputs or {}).items():
            inputs[k] = torch.as_tensor(np.asarray(v), device=self.device)
        gen = _generator(self.device, self.scfg.seed)

        t0 = time.perf_counter()
        logits, caches = M.prefill(self.params, inputs, self.cfg,
                                   max_len=self.scfg.max_len)
        token = _pick(logits, self.scfg.temperature, gen)
        out = [token.cpu().numpy()]
        self.stats["prefill_s"] += time.perf_counter() - t0

        done = np.zeros(b, bool)
        t0 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            if eos_id is not None:
                done |= (out[-1] == eos_id)
                if done.all():
                    break
            logits, caches = M.decode_step(self.params, caches, token,
                                           self.cfg)
            token = _pick(logits, self.scfg.temperature, gen)
            out.append(token.cpu().numpy())
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["tokens_out"] += int(np.size(out))
        return np.stack(out, axis=1)


def static_batches(prompts, budgets, capacity: int):
    """The static-batch baseline's serving plan: arrival-order chunks of
    ``capacity``, prompts left-padded to the batch max, each batch decoding
    to its largest budget.  Yields ``(padded_prompts, new_tokens, indices)``."""
    for s in range(0, len(prompts), capacity):
        idxs = list(range(s, min(s + capacity, len(prompts))))
        plen = max(len(prompts[j]) for j in idxs)
        padded = np.zeros((len(idxs), plen), np.int32)
        for r, j in enumerate(idxs):
            padded[r, plen - len(prompts[j]):] = prompts[j]
        yield padded, max(budgets[j] for j in idxs), idxs


# ======================================================= continuous batching
@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is an unbatched (S,) token
    vector; ``extra`` holds unbatched per-request extra inputs (``embeds``
    (S, d) for a VLM embedding prompt), which the engine batches."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None = None
    extra: dict[str, np.ndarray] | None = None
    # -- filled by the engine ------------------------------------------------
    tokens: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: float | None = None
    finished_at: float | None = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


#: the engine's cumulative counters; ``stats`` assembles them in this order
_STAT_KEYS = ("prefill_s", "decode_s", "tokens_out", "prefill_tokens",
              "submitted", "admitted", "completed", "steps", "decode_steps",
              "occupancy_sum", "queue_depth_sum", "prefill_compiles",
              "prefix_hits", "prefix_tokens_saved", "chunk_steps",
              "schedule_swaps")


@dataclasses.dataclass
class _ChunkTask:
    """A slot mid chunked-prefill: the first ``pos`` prompt tokens are
    already in its pages (shared-prefix pages and/or completed chunks)."""

    req: Request
    slot: int
    pos: int


def _shape_key(req: Request) -> tuple:
    """Prefill-coalescing key: requests with equal keys prefill as one
    group."""
    return (len(req.prompt),
            tuple(sorted((k, np.asarray(v).shape)
                         for k, v in (req.extra or {}).items())))


def _has_embeds(req: Request) -> bool:
    return bool(req.extra) and "embeds" in req.extra


def _ratio(num: float, den: float) -> float:
    """A derived rate that is 0.0 (never inf/NaN) for zero-step runs."""
    return num / den if den > 0 else 0.0


class ContinuousEngine:
    """Continuous-batching engine (see module docstring).

    One :meth:`step` = admit-from-queue (prefill each admitted group at its
    exact prompt length, splice into its slots, emit its first token) + one
    lockstep decode over the slot batch.  :meth:`run` steps until drained.
    Greedy decoding is token-identical to single-request
    ``Engine.generate`` for every request, whatever the arrival order
    (an MoE model's only where no dispatch drops a copy, as the module
    docstring says).

    ``stats`` keeps every counter of the JAX engine: ``prefill_compiles``
    counts distinct prefill shapes exactly as JAX counts its compiles (and
    restarts with a swap, as JAX's trace caches do), and ``schedule_swaps``
    counts the store commits the engine picked up mid-flight.  ``recorder``
    (optional) logs every submit, prefill and decode dispatch.
    """

    def __init__(self, params, cfg: ModelConfig,
                 scfg: ServeConfig | None = None,
                 on_token: Callable[[Request, int], None] | None = None,
                 obs: obs_metrics.MetricsRegistry | None = None,
                 recorder: WorkloadRecorder | None = None,
                 mesh=None):
        check_supported(cfg)
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch has no tensor-parallel serving yet (ROADMAP.md, "
                "Queue 1: distribution)")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg = ServeConfig() if scfg is None else scfg
        self.capacity = scfg.capacity
        self.device = _device_of(params)
        self.on_token = on_token
        self.obs = obs if obs is not None else obs_metrics.MetricsRegistry()
        self.recorder = recorder
        self.pool = SlotPool(scfg.capacity)
        # conv-state shapes only stabilize once the prompt covers the conv
        # receptive field — shorter prompts would prefill a cache segment that
        # cannot be spliced into the fixed-shape slot batch
        self._min_prompt = (cfg.conv_width - 1
                            if cfg.family in ("ssm", "hybrid") else 1)
        self.paged = scfg.paged
        if self.paged:
            if cfg.family not in M.ATTENTION_FAMILIES:
                raise ValueError(
                    f"paged serving supports {M.ATTENTION_FAMILIES}, not "
                    f"{cfg.family!r} (its decode state is dense per-slot)")
            if scfg.admission not in ("queue", "reject"):
                raise ValueError(f"admission must be 'queue' or 'reject', "
                                 f"got {scfg.admission!r}")
            if scfg.prefill_chunk is not None and scfg.prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{scfg.prefill_chunk}")
            ps = scfg.page_size
            self._n_slot_pages = -(-scfg.max_len // ps)
            num_pages = (scfg.num_pages if scfg.num_pages is not None
                         else scfg.capacity * self._n_slot_pages + 1)
            # page 0 is the trash page: a freed/idle slot's zeroed page-table
            # row makes its masked decode scatters land there harmlessly
            self.pages = PagePool(num_pages, ps, obs=self.obs)
            self.prefix = (PrefixCache(self.pages, obs=self.obs)
                           if scfg.prefix_cache else None)
            self.caches = M.alloc_paged_caches(cfg, scfg.capacity, ps,
                                               num_pages, device=self.device)
            # host-side page tables, (capacity, n_slot_pages) int32 — passed
            # into every paged dispatch; a slot's row is zeroed while free
            self._pt = np.zeros((scfg.capacity, self._n_slot_pages), np.int32)
            self._slot_pages: dict[int, list[int]] = {}
            self._chunk_tasks: collections.deque[_ChunkTask] = \
                collections.deque()
            self._prefilling: set[int] = set()
        else:
            self.caches = M.alloc_slot_caches(cfg, scfg.capacity,
                                              scfg.max_len, device=self.device)
        self._make_dispatchers()
        # schedule hot-swap: the store the engine is built under and its
        # version; _maybe_refresh_schedules() swaps when the version moves
        self._sched_cache = active_schedule_cache()
        self._sched_version = (self._sched_cache.version
                               if self._sched_cache is not None else 0)
        self.tokens = np.zeros(scfg.capacity, np.int32)   # next decode inputs
        self._gen = _generator(self.device, scfg.seed)
        self._uid = 0
        self._prefill_shapes_seen: set[tuple] = set()
        self._c = {k: self.obs.counter(f"serve.{k}") for k in _STAT_KEYS}
        self._g_occupancy = self.obs.gauge("serve.occupancy")
        self._g_queue_depth = self.obs.gauge("serve.queue_depth")
        if self.paged:
            self._g_page_occ = self.obs.gauge("serve.page_occupancy")
        self._h_ttft = self.obs.histogram("serve.ttft_s")
        self._h_itl = self.obs.histogram("serve.inter_token_s")
        self._h_prefill = self.obs.histogram("serve.prefill_call_s")
        self._h_decode = self.obs.histogram("serve.decode_step_s")
        self._last_emit: dict[int, float] = {}   # uid -> last token time

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _make_dispatchers(self) -> None:
        """(Re)build what the engine dispatches through; called at
        construction and on every schedule swap.  The JAX engine re-creates
        its jitted step functions here, since a jit trace would keep the
        schedules it resolved.  Eager dispatch keeps nothing to drop: each
        registry kernel re-resolves its schedule on its first call after
        the store's version moves (``SipKernel.__call__``), so the next
        dispatch already serves the new schedule.  Captured step graphs
        would be re-captured here."""

    def _maybe_refresh_schedules(self) -> None:
        """Pick up a commit to the store the engine was built under (an
        autotune promotion, or a tuning session sharing the store) without
        a restart: count the swap, restart the compile accounting, rebuild
        the dispatchers and mark the trace.  Caches, page tables, slots and
        requests in flight are untouched.

        Polled before EVERY dispatch (admission prefill, chunked prefill,
        decode), not only at the top of :meth:`step`: a commit can land
        mid-step (an autotune thread promoting between the admission
        prefill and the decode, or an ``on_token`` callback committing
        during emission), and the rest of that step must not run on stale
        schedules."""
        cache = self._sched_cache
        if cache is None or not cache.changed_since(self._sched_version):
            return
        self._sched_version = cache.version
        self._c["schedule_swaps"].inc()
        self._prefill_shapes_seen.clear()
        self._make_dispatchers()
        obs_trace.instant("serve.schedule_swap", version=cache.version)

    # -------------------------------------------------------------- ingress
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               eos_id: int | None = None,
               extra: dict[str, np.ndarray] | None = None) -> Request:
        """Enqueue one request; returns its :class:`Request` handle.
        ``extra={"embeds": (S, d)}`` gives an embeddings-mode model its
        prompt; S must be the prompt's length."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) < self._min_prompt:
            raise ValueError(
                f"{self.cfg.family} prompts need >= {self._min_prompt} "
                f"tokens (conv receptive field), got {len(prompt)}")
        total = len(prompt) + max_new_tokens
        if not self.paged:
            if total > self.scfg.max_len:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds max_len "
                    f"({self.scfg.max_len})")
        else:
            # paged admission is a CAPACITY check, not a length check: the
            # hard bound is the page-rounded per-slot page table; whether
            # the request can start is a question about free pages
            ps = self.pages.page_size
            bound = self._n_slot_pages * ps
            if total > bound:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds the per-slot page table "
                    f"({self._n_slot_pages} pages x {ps} = {bound} tokens)")
            worst = -(-total // ps)
            if worst > self.pages.usable_pages:
                raise ValueError(
                    f"request needs {worst} pages but the pool has only "
                    f"{self.pages.usable_pages} usable — it could never be "
                    f"admitted; raise num_pages")
            if self.scfg.admission == "reject" and not self._admissible(worst):
                raise PagesExhausted(
                    f"request needs {worst} pages now but "
                    f"free={self.pages.free_pages} + evictable="
                    f"{self.prefix.evictable_pages if self.prefix else 0}, "
                    f"free_slots={self.pool.free_slots}, "
                    f"queued={self.pool.queue_depth} — resubmit later or "
                    f"serve with admission='queue'")
        got = {k: tuple(np.asarray(v).shape) for k, v in (extra or {}).items()}
        if "embeds" in got and got["embeds"][0] != len(prompt):
            # prefill advances the cache by the EMBEDS length, so a mismatch
            # would silently break the max_len/position accounting above
            raise ValueError(f"extra 'embeds' length {got['embeds'][0]} "
                             f"must match the prompt length {len(prompt)}")
        req = Request(uid=self._uid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      extra=extra, submitted_at=time.perf_counter())
        self._uid += 1
        self._c["submitted"].inc()
        if self.recorder is not None:
            self.recorder.record("submit", prompt_len=len(prompt),
                                 dtype=self.cfg.dtype,
                                 new_tokens=max_new_tokens,
                                 occupancy=self.pool.occupancy,
                                 queue_depth=self.pool.queue_depth)
        self.pool.submit(req)
        return req

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Admit + prefill waiting requests into free slots, then run one
        lockstep decode over the occupied batch.  Returns requests that
        finished during this step."""
        self._maybe_refresh_schedules()
        finished: list[Request] = []
        if self.paged:
            self._admit_paged(finished)
            if self._chunk_tasks:
                self._chunk_step(finished)
            self._decode_paged(finished)
            self._g_page_occ.set(_ratio(self.pages.used_pages,
                                        self.pages.usable_pages))
        else:
            groups: dict[tuple, list[tuple[int, Request]]] = {}
            for slot, req in self.pool.admit():
                # coalesce same-shape admissions into one batched prefill
                groups.setdefault(_shape_key(req), []).append((slot, req))
            for group in groups.values():
                self._admit_group(group, finished)
            if self.pool.occupancy:
                self._decode_contiguous(finished)
        self._c["steps"].inc()
        self._c["occupancy_sum"].inc(self.pool.occupancy)
        self._c["queue_depth_sum"].inc(self.pool.queue_depth)
        self._g_occupancy.set(self.pool.occupancy)
        self._g_queue_depth.set(self.pool.queue_depth)
        return finished

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Step until queue and slots drain; returns {uid: generated tokens}."""
        out: dict[int, np.ndarray] = {}
        steps = 0
        while not self.pool.idle:
            for req in self.step():
                out[req.uid] = req.output
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"engine not drained after {max_steps} "
                                   f"steps ({self.pool!r})")
        return out

    # ------------------------------------------------------------ internals
    def _decode_contiguous(self, finished: list[Request]) -> None:
        self._maybe_refresh_schedules()
        occ = self.pool.occupancy
        t0 = time.perf_counter()
        with obs_trace.span("serve.decode", occupancy=occ):
            logits, self.caches = M.decode_step(
                self.params, self.caches, self._dev(self.tokens), self.cfg)
            tok = _pick(logits, self.scfg.temperature, self._gen).cpu().numpy()
        self._record_decode(time.perf_counter() - t0, occ)
        for slot, req in list(self.pool.held()):
            self.tokens[slot] = int(tok[slot])
            self._emit(slot, req, int(tok[slot]), finished)

    def _record_decode(self, dt: float, occupancy: int) -> None:
        self._c["decode_s"].inc(dt)
        self._c["decode_steps"].inc()
        self._h_decode.record(dt)
        if self.recorder is not None:
            self.recorder.record("decode", batch=self.capacity,
                                 dtype=self.cfg.dtype, occupancy=occupancy,
                                 queue_depth=self.pool.queue_depth)

    def _admit_group(self, group: list[tuple[int, Request]],
                     finished: list[Request]) -> None:
        self._maybe_refresh_schedules()
        t0 = time.perf_counter()
        slots = np.asarray([s for s, _ in group], np.int32)
        prompts = np.stack([r.prompt for _, r in group])
        inputs = {"tokens": self._dev(prompts)}
        for k in (group[0][1].extra or {}):
            inputs[k] = self._dev(np.stack([np.asarray(r.extra[k])
                                            for _, r in group]))
        if self.paged:
            # prefill at the prompt length rounded up to a page multiple —
            # the group cache then splits exactly into pages; the JAX engine
            # compiles once per rounded length, so that is what is counted
            ps = self.pages.page_size
            n_pg = -(-int(prompts.shape[1]) // ps)
            shape = (len(group), n_pg * ps)
        else:
            shape = (len(group), prompts.shape[1])
        if shape not in self._prefill_shapes_seen:
            self._prefill_shapes_seen.add(shape)
            self._c["prefill_compiles"].inc()
        with obs_trace.span("serve.prefill", batch=len(group),
                            prompt_len=int(prompts.shape[1])):
            if self.paged:
                logits, grp = M.prefill(self.params, inputs, self.cfg,
                                        max_len=n_pg * ps)
                page_rows = np.asarray(
                    [self._slot_pages[s][:n_pg] for s in slots], np.int32)
                self.caches = M.insert_pages(self.caches, grp,
                                             self._dev(slots),
                                             self._dev(page_rows))
            else:
                logits, grp = M.prefill(self.params, inputs, self.cfg,
                                        max_len=self.scfg.max_len)
                self.caches = M.insert_slots(self.caches, grp,
                                             self._dev(slots))
            toks = _pick(logits, self.scfg.temperature,
                         self._gen).cpu().numpy()
        dt = time.perf_counter() - t0
        self._c["prefill_s"].inc(dt)
        self._h_prefill.record(dt)
        self._c["prefill_tokens"].inc(int(prompts.size))
        self._c["admitted"].inc(len(group))
        if self.recorder is not None:
            self.recorder.record("prefill", prompt_len=int(prompts.shape[1]),
                                 batch=len(group), dtype=self.cfg.dtype,
                                 occupancy=self.pool.occupancy,
                                 queue_depth=self.pool.queue_depth)
        now = time.perf_counter()
        for (slot, req), tok in zip(group, toks):
            req.admitted_at = now
            self._h_ttft.record(now - req.submitted_at)
            if self.paged:
                # register BEFORE _emit: a 1-token request releases its slot
                # (and pages) inside _emit, and the prefix cache must take
                # its references first
                self._register_prefix(req, slot)
            self.tokens[slot] = int(tok)
            self._emit(slot, req, int(tok), finished)

    # ------------------------------------------------------ paged internals
    def _admissible(self, worst: int) -> bool:
        """Could a ``worst``-page request start right NOW (the 'reject'
        admission policy's test)?  Prefix hits it might get are not
        counted, reclaimable cache pages are."""
        evictable = self.prefix.evictable_pages if self.prefix else 0
        return (self.pool.free_slots > 0 and self.pool.queue_depth == 0
                and worst <= self.pages.free_pages + evictable)

    def _admit_paged(self, finished: list[Request]) -> None:
        """FIFO admission gated on pages: admit head-of-line requests while
        a slot AND their worst-case pages are available; the first request
        that does not fit blocks the line."""
        groups: dict[tuple, list[tuple[int, Request]]] = {}
        while self.pool.free_slots:
            req = self.pool.peek()
            if req is None:
                break
            plan = self._plan_pages(req)
            if plan is None:
                break
            slot, _ = self.pool.admit_one()
            self._install(slot, req, plan, groups)
        for group in groups.values():
            self._admit_group(group, finished)

    def _plan_pages(self, req: Request) -> tuple[list[int], list[int]] | None:
        """Reserve every page ``req`` could ever need — shared prefix pages
        first, the rest allocated fresh, so decode never allocates.  Returns
        ``(shared, fresh)`` or None (caller waits); on failure any retained
        shared pages are released."""
        ps = self.pages.page_size
        worst = -(-(len(req.prompt) + req.max_new_tokens) // ps)
        shared: list[int] = []
        if self.prefix is not None and not _has_embeds(req):
            # embedding prompts carry content outside the token ids, which
            # is all the prefix hash sees: never share those
            shared = self.prefix.lookup(req.prompt)
        need = worst - len(shared)
        fresh = self.pages.alloc(need)
        if fresh is None and self.prefix is not None:
            # squeeze idle prefix entries before making the line wait
            self.prefix.evict(need - self.pages.free_pages)
            fresh = self.pages.alloc(need)
        if fresh is None:
            if shared:
                self.pages.release(shared)
            return None
        return shared, fresh

    def _install(self, slot: int, req: Request,
                 plan: tuple[list[int], list[int]],
                 groups: dict[tuple, list[tuple[int, Request]]]) -> None:
        """Wire an admitted request's page table and route it to a prefill
        path: chunked (prefix hit, or prompt longer than ``prefill_chunk``)
        or the same-length batched group."""
        shared, fresh = plan
        ps = self.pages.page_size
        pages = shared + fresh
        self._slot_pages[slot] = pages
        self._pt[slot] = 0
        self._pt[slot, :len(pages)] = pages
        m_tok = len(shared) * ps
        cs = self.scfg.prefill_chunk
        if m_tok or (cs is not None and len(req.prompt) - m_tok > cs):
            if m_tok:
                self._c["prefix_hits"].inc()
                self._c["prefix_tokens_saved"].inc(m_tok)
            # the slot's cache position starts at the shared-prefix length
            # (0 when none); eviction is lazy, so the length still holds the
            # previous occupant's value until set here
            self.caches = M.set_slot_lens(self.caches, slot, m_tok)
            self._prefilling.add(slot)
            self._chunk_tasks.append(_ChunkTask(req=req, slot=slot,
                                                pos=m_tok))
        else:
            groups.setdefault(_shape_key(req), []).append((slot, req))

    def _chunk_step(self, finished: list[Request]) -> None:
        """Advance the head chunk task by ONE chunk, so a long prompt cannot
        stall the decode batch for its whole length.  The final (short)
        chunk runs zero-padded at the fixed chunk shape."""
        self._maybe_refresh_schedules()
        task = self._chunk_tasks[0]
        req, slot = task.req, task.slot
        remaining = len(req.prompt) - task.pos
        cs = self.scfg.prefill_chunk or remaining
        n = min(cs, remaining)
        buf = np.zeros((1, cs), np.int32)
        buf[0, :n] = req.prompt[task.pos:task.pos + n]
        embeds = eshape = None
        if _has_embeds(req):
            e = np.asarray(req.extra["embeds"])
            ebuf = np.zeros((1, cs) + e.shape[1:], e.dtype)
            ebuf[0, :n] = e[task.pos:task.pos + n]
            embeds = self._dev(ebuf)
            eshape = tuple(e.shape[1:])
        shape = ("chunk", cs, eshape)
        if shape not in self._prefill_shapes_seen:
            self._prefill_shapes_seen.add(shape)
            self._c["prefill_compiles"].inc()
        t0 = time.perf_counter()
        with obs_trace.span("serve.prefill_chunk", slot=slot, chunk=int(cs),
                            valid=int(n)):
            last, self.caches = M.prefill_chunk(
                self.params, self.caches, self._dev(buf),
                self._dev(self._pt[slot:slot + 1]), slot, n, self.cfg,
                embeds=embeds)
            _sync(self.device)
        dt = time.perf_counter() - t0
        self._c["prefill_s"].inc(dt)
        self._h_prefill.record(dt)
        self._c["prefill_tokens"].inc(int(n))
        self._c["chunk_steps"].inc()
        if self.recorder is not None:
            self.recorder.record("prefill", prompt_len=int(cs), batch=1,
                                 dtype=self.cfg.dtype,
                                 occupancy=self.pool.occupancy,
                                 queue_depth=self.pool.queue_depth)
        task.pos += n
        if task.pos < len(req.prompt):
            return
        self._chunk_tasks.popleft()
        self._prefilling.discard(slot)
        tok = int(_pick(last, self.scfg.temperature, self._gen)[0])
        now = time.perf_counter()
        req.admitted_at = now
        self._h_ttft.record(now - req.submitted_at)
        self._c["admitted"].inc()
        self._register_prefix(req, slot)
        self.tokens[slot] = tok
        self._emit(slot, req, tok, finished)

    def _register_prefix(self, req: Request, slot: int) -> None:
        """Offer a freshly prefilled prompt's full pages to the prefix cache
        (idempotent for already-known blocks); an embedding prompt's never."""
        if self.prefix is None or _has_embeds(req):
            return
        n_full = (len(req.prompt) - 1) // self.pages.page_size
        if n_full:
            # the FULL prompt goes to insert — its key chain already stops
            # at the last shareable block
            self.prefix.insert(req.prompt, self._slot_pages[slot][:n_full])

    def _decode_paged(self, finished: list[Request]) -> None:
        """One lockstep decode over slots NOT mid chunked-prefill: the
        ``active`` mask keeps inactive rows from writing real pages or
        advancing their cache position."""
        decoding = [s for s, _ in self.pool.held()
                    if s not in self._prefilling]
        if not decoding:
            return
        self._maybe_refresh_schedules()
        occ = len(decoding)
        active = np.zeros(self.capacity, bool)
        active[decoding] = True
        t0 = time.perf_counter()
        with obs_trace.span("serve.decode", occupancy=occ):
            logits, self.caches = M.decode_step(
                self.params, self.caches, self._dev(self.tokens), self.cfg,
                pt=self._dev(self._pt), active=self._dev(active))
            tok = _pick(logits, self.scfg.temperature, self._gen).cpu().numpy()
        self._record_decode(time.perf_counter() - t0, occ)
        for slot, req in list(self.pool.held()):
            if slot in self._prefilling:
                continue
            self.tokens[slot] = int(tok[slot])
            self._emit(slot, req, int(tok[slot]), finished)

    def _emit(self, slot: int, req: Request, tok: int,
              finished: list[Request]) -> None:
        req.tokens.append(tok)
        now = time.perf_counter()
        last = self._last_emit.get(req.uid)
        if last is not None:
            self._h_itl.record(now - last)
        self._last_emit[req.uid] = now
        self._c["tokens_out"].inc()
        if self.on_token is not None:
            self.on_token(req, tok)
        if (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.finished_at = time.perf_counter()
            self._last_emit.pop(req.uid, None)
            # eviction is lazy: a freed slot's stale state is confined to its
            # own batch row, and the next admission overwrites the row
            self.pool.release(slot)
            if self.paged:
                # drop the slot's page references (prefix-shared pages stay
                # alive through the cache's own ref) and zero its page-table
                # row so stale decode scatters land in the trash page
                pages = self._slot_pages.pop(slot, None)
                if pages:
                    self.pages.release(pages)
                self._pt[slot] = 0
            self._c["completed"].inc()
            finished.append(req)

    # -------------------------------------------------------------- metrics
    @property
    def stats(self) -> dict[str, Any]:
        """Cumulative counters, assembled from the metrics registry."""
        return {k: c.value for k, c in self._c.items()}

    def metrics(self) -> dict[str, float]:
        """Derived serving metrics (gauge means are per engine step); every
        ratio is 0.0, never inf/NaN, for a zero-step engine."""
        s = self.stats
        busy = s["prefill_s"] + s["decode_s"]
        out = {
            "queue_depth": float(self.pool.queue_depth),
            "slot_occupancy": float(self.pool.occupancy),
            "mean_occupancy": _ratio(s["occupancy_sum"], s["steps"]),
            "mean_queue_depth": _ratio(s["queue_depth_sum"], s["steps"]),
            "prefill_s": float(s["prefill_s"]),
            "decode_s": float(s["decode_s"]),
            "prefill_frac": _ratio(s["prefill_s"], busy),
            "tokens_per_s": _ratio(s["tokens_out"], busy),
            "decode_tokens_per_s": _ratio(s["tokens_out"] - s["admitted"],
                                          s["decode_s"]),
        }
        if self.paged:
            out.update({
                "page_occupancy": _ratio(self.pages.used_pages,
                                         self.pages.usable_pages),
                "free_pages": float(self.pages.free_pages),
                "prefix_hits": float(s["prefix_hits"]),
                "prefix_tokens_saved": float(s["prefix_tokens_saved"]),
                "prefix_entries": float(len(self.prefix)
                                        if self.prefix else 0),
                "chunk_steps": float(s["chunk_steps"]),
            })
        return out
