"""Fixed-size KV-cache pages: a refcounted page pool + content-hashed
prefix cache — the bookkeeping core of paged serving memory.

The continuous-batching engine stops giving every slot a contiguous
``max_len`` cache segment; instead the KV store is one flat array of
``num_pages`` pages of ``page_size`` token positions each, and every slot
owns a *page table* (a row of page ids).  This module is the host-side
allocator for that store, kept model-free — like :class:`~repro_torch.serve.slots.
SlotPool` — so its invariants are property-testable in isolation
(tests/test_page_pool.py):

* **no writer aliasing** — a page handed out by :meth:`PagePool.alloc` has
  refcount 1 and is never simultaneously live in another allocation; pages
  only become shared through explicit :meth:`retain` (prefix sharing), and
  shared pages are read-only by convention (:meth:`writable` is the check,
  :meth:`cow` the escape hatch);
* **exact lifetimes** — a page's refcount hits zero exactly when its last
  holder releases it, at which point it re-enters the free list;
* **no double-free** — releasing a free page raises instead of corrupting
  the free list.

Page 0 (more generally ``reserved``) is never allocated: the engine keeps it
as the *trash page* — idle/inactive batch rows carry an all-zero page-table
row, so their lockstep decode writes land harmlessly in page 0 instead of
needing a per-row dispatch guard.

:class:`PrefixCache` maps chain-hashed page-aligned token blocks to pages so
requests sharing a system-prompt prefix prefill once and alias the pages
read-only.  The cache holds one reference per registered page; LRU eviction
(:meth:`PrefixCache.evict`) returns pages to the pool under memory pressure.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics


class PagesExhausted(RuntimeError):
    """Raised under the ``reject`` admission policy when a request cannot be
    granted its worst-case page reservation right now."""


class PagePool:
    """``num_pages`` fixed-size pages with refcounted lifetimes.

    ``alloc(n)`` hands out ``n`` pages at refcount 1 (lowest ids first, so
    placement is deterministic), ``retain`` adds a reference (prefix
    sharing), ``release`` drops one and returns the page to the free list at
    zero.  ``reserved`` pages (default: page 0, the trash page) are never
    allocated or released.
    """

    def __init__(self, num_pages: int, page_size: int,
                 reserved: Sequence[int] = (0,),
                 obs: obs_metrics.MetricsRegistry | None = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._reserved = frozenset(reserved)
        if num_pages <= len(self._reserved):
            raise ValueError(f"num_pages must exceed the {len(self._reserved)}"
                             f" reserved page(s), got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._ref = np.zeros(num_pages, np.int32)
        # pop() -> lowest id; kept sorted descending like SlotPool's free list
        self._free = sorted((i for i in range(num_pages)
                             if i not in self._reserved), reverse=True)
        # optional telemetry (repro_torch.obs): the engine passes its registry so
        # pool occupancy shares one surface with the serve.* metrics.
        # `is not None`, not truthiness: an empty registry is falsy (len 0)
        has_obs = obs is not None
        self._g_occ = (obs.gauge("serve.page_pool.occupancy")
                       if has_obs else None)
        self._c_alloc = (obs.counter("serve.page_pool.alloc_pages")
                         if has_obs else None)
        self._c_freed = (obs.counter("serve.page_pool.freed_pages")
                         if has_obs else None)

    def _observe(self) -> None:
        if self._g_occ is not None:
            self._g_occ.set(self.used_pages / self.usable_pages)

    # ---------------------------------------------------------- allocation
    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages at refcount 1, or None if the pool cannot
        satisfy the whole request (all-or-nothing: a partial grant would
        leak pages on the caller's retry path)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        if self._c_alloc is not None and pages:
            self._c_alloc.inc(len(pages))
        self._observe()
        return pages

    def retain(self, pages: int | Iterable[int]) -> None:
        """Add one reference to each live page (prefix sharing)."""
        for p in self._as_pages(pages):
            if self._ref[p] <= 0:
                raise ValueError(f"retain of free page {p}")
            self._ref[p] += 1

    def release(self, pages: int | Iterable[int]) -> int:
        """Drop one reference per page; pages hitting zero return to the
        free list.  Releasing an already-free (or reserved) page raises —
        the double-free guard.  Returns how many pages were actually freed."""
        freed = 0
        try:
            for p in self._as_pages(pages):
                if self._ref[p] <= 0:
                    raise ValueError(f"double free of page {p}")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
        finally:
            # one sort per call, not per page; finally keeps the descending
            # free-list invariant even when a double-free raises mid-batch
            if freed:
                self._free.sort(reverse=True)
                if self._c_freed is not None:
                    self._c_freed.inc(freed)
                self._observe()
        return freed

    def cow(self, page: int) -> int | None:
        """Copy-on-write: break this holder's share of ``page``.

        Allocates a fresh page (refcount 1), moves one reference off
        ``page``, and returns the new page id — the caller owns copying the
        page *contents* (a device-side scatter) and repointing its page
        table.  Returns None when the pool is exhausted; a no-op escape for
        already-exclusive pages is :meth:`writable`.

        The engine's whole-page-aligned prefix sharing never needs this
        (shared pages are full and frozen; the first written position always
        lands on a fresh page), but sub-page sharing policies do — and the
        pool-level invariant (a writer never aliases a shared page) is
        property-tested either way.
        """
        if self._ref[page] <= 0:
            raise ValueError(f"cow of free page {page}")
        got = self.alloc(1)
        if got is None:
            return None
        self.release(page)
        return got[0]

    # -------------------------------------------------------------- queries
    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def writable(self, page: int) -> bool:
        """True when exactly one holder references ``page`` — the only state
        in which in-place writes cannot corrupt another request's cache."""
        return self._ref[page] == 1

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus reserved) — the capacity bound."""
        return self.num_pages - len(self._reserved)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def _as_pages(self, pages: int | Iterable[int]) -> list[int]:
        out = [int(pages)] if isinstance(pages, (int, np.integer)) \
            else [int(p) for p in pages]
        for p in out:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range [0, {self.num_pages})")
            if p in self._reserved:
                raise ValueError(f"page {p} is reserved (trash page)")
        return out

    def __repr__(self) -> str:
        return (f"PagePool(num_pages={self.num_pages}, "
                f"page_size={self.page_size}, free={self.free_pages}, "
                f"used={self.used_pages})")


# ========================================================== prefix sharing
@dataclasses.dataclass
class _PrefixEntry:
    page: int
    last_used: int


class PrefixCache:
    """Content-hashed full-page token blocks -> cache pages.

    Keys are *chain* hashes — block ``i``'s key folds in block ``i-1``'s key
    — so a hit on block ``i`` guarantees the whole prefix up to and including
    block ``i`` matches, not just that one block's tokens.  Only pages whose
    ``page_size`` tokens are fully covered by the prompt minus its last
    token are ever registered/matched: the tail token must always prefill so
    the admitting request gets its first-token logits, and partially-filled
    pages are writable (sharing them would alias a writer).

    The cache holds ONE pool reference per registered page.  ``lookup``
    retains matched pages on behalf of the caller (who must release them on
    any failure path); ``evict`` releases LRU entries until enough pages
    actually returned to the free list.
    """

    def __init__(self, pool: PagePool,
                 obs: obs_metrics.MetricsRegistry | None = None):
        self.pool = pool
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional telemetry (repro_torch.obs), same registry surface as serve.*
        # (`is not None`: an empty registry is falsy)
        has_obs = obs is not None
        self._c_hits = (obs.counter("serve.prefix_cache.hits")
                        if has_obs else None)
        self._c_misses = (obs.counter("serve.prefix_cache.misses")
                          if has_obs else None)
        self._c_evictions = (obs.counter("serve.prefix_cache.evictions")
                             if has_obs else None)
        self._c_evicted_pages = (obs.counter("serve.prefix_cache."
                                             "evicted_pages")
                                 if has_obs else None)
        self._g_entries = (obs.gauge("serve.prefix_cache.entries")
                           if has_obs else None)

    def _keys(self, tokens: np.ndarray) -> list[bytes]:
        """Chain-hash keys for every *shareable* full block of ``tokens``."""
        ps = self.pool.page_size
        n_share = max(0, (len(tokens) - 1) // ps)
        keys, prev = [], b""
        arr = np.asarray(tokens, np.int32)
        for i in range(n_share):
            h = hashlib.sha256(prev)
            h.update(arr[i * ps:(i + 1) * ps].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Longest already-cached page run covering a prefix of ``tokens``.

        Returns the page ids (possibly empty); each is retained for the
        caller.  Counts one hit when any pages matched, else one miss
        (prompts too short to span a full block count as neither)."""
        keys = self._keys(tokens)
        pages: list[int] = []
        self._clock += 1
        for key in keys:
            ent = self._entries.get(key)
            if ent is None:
                break
            ent.last_used = self._clock
            self.pool.retain(ent.page)
            pages.append(ent.page)
        if keys:
            if pages:
                self.hits += 1
                if self._c_hits is not None:
                    self._c_hits.inc()
            else:
                self.misses += 1
                if self._c_misses is not None:
                    self._c_misses.inc()
        return pages

    def insert(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """Register the full-page blocks of ``tokens`` (one page id per
        block, in order).  Already-known blocks are skipped; newly
        registered pages gain one cache-held reference.  Returns how many
        blocks were newly registered."""
        keys = self._keys(tokens)
        if len(pages) < len(keys):
            raise ValueError(f"{len(keys)} shareable blocks but only "
                             f"{len(pages)} pages")
        added = 0
        self._clock += 1
        for key, page in zip(keys, pages):
            ent = self._entries.get(key)
            if ent is not None:
                ent.last_used = self._clock
                continue
            self.pool.retain(page)
            self._entries[key] = _PrefixEntry(int(page), self._clock)
            added += 1
        if self._g_entries is not None:
            self._g_entries.set(len(self._entries))
        return added

    def evict(self, want_freed: int) -> int:
        """Release LRU *exclusively-held* entries until ``want_freed`` pages
        returned to the free list or none remain.  Entries whose page is
        still shared with a live slot are kept: evicting them frees nothing
        (the slot's reference pins the page) and only forfeits future
        sharing — they become evictable when their last slot releases.
        Returns the number of pages freed."""
        freed = 0
        while freed < want_freed and self._entries:
            key = min(self._entries,
                      key=lambda k: (not self.pool.writable(
                          self._entries[k].page),
                          self._entries[k].last_used))
            if not self.pool.writable(self._entries[key].page):
                break  # best candidate still shared -> nothing reclaimable
            ent = self._entries.pop(key)
            self.evictions += 1
            if self._c_evictions is not None:
                self._c_evictions.inc()
            n = self.pool.release(ent.page)
            freed += n
            if self._c_evicted_pages is not None and n:
                self._c_evicted_pages.inc(n)
        if self._g_entries is not None:
            self._g_entries.set(len(self._entries))
        return freed

    @property
    def evictable_pages(self) -> int:
        """Pages eviction could actually return to the free list right now
        (entries whose page the cache holds exclusively) — the admission
        check's honest view of reclaimable capacity."""
        return sum(1 for e in self._entries.values()
                   if self.pool.writable(e.page))

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return (f"PrefixCache(entries={len(self._entries)}, "
                f"hits={self.hits}, misses={self.misses})")
