"""Offline schedule store (paper §4.1).

"SIP is expected to perform offline searches and store results from multiple
rounds of searches.  Then it applies a greedy algorithm to rank all found
cubin and picks the best one if it passes all tests.  Finally, at deployment,
the best cubin is retrieved and loaded directly without incurring any runtime
overhead."

Entries are keyed by (kernel_name, signature) where signature encodes the
input shapes/dtypes and the hardware target — the analogue of one compiled
cubin per launch configuration.  Storage is a single JSON file with atomic
replace so concurrent searches do not corrupt it.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import threading
import warnings
from typing import Any, Callable, Sequence

from repro_torch.core.schedule import Schedule


class LRUCache:
    """Small bounded LRU with hit/miss accounting.

    Used by ``SipKernel.tune`` to share built kernels between the
    step-test gate, wall-clock timing, and the final heavy test — one
    ``_build`` per schedule instead of three — while bounding the number of
    live compiled executables the search keeps around.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._data: collections.OrderedDict[Any, Any] = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Any) -> bool:
        return key in self._data

    def get_or_build(self, key: Any, build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building (and possibly
        evicting the least-recently-used entry) on miss."""
        if key in self._data:
            self.hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.misses += 1
        value = build()
        self._data[key] = value
        if len(self._data) > self.maxsize:
            self._data.popitem(last=False)
        return value

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._data)}

    def reset_stats(self) -> None:
        """Zero the hit/miss counters (entries are kept) — used to scope
        build-cache stats to one tuning round."""
        self.hits = 0
        self.misses = 0


@dataclasses.dataclass
class CacheEntry:
    schedule_json: str
    energy: float              # seconds (raw)
    tests_passed: bool
    test_samples: int
    round_id: int
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CacheEntry":
        return CacheEntry(**d)


@dataclasses.dataclass(frozen=True)
class PendingPut:
    """One staged :meth:`ScheduleCache.commit` entry — a ``put`` that has not
    happened yet.  The autotune promotion path stages every gated winner of a
    cycle and lands them in ONE commit: one version bump, one atomic flush,
    so engines watching :meth:`ScheduleCache.changed_since` re-resolve once
    per promotion batch instead of once per entry."""

    kernel_name: str
    signature: str
    schedule: Schedule
    energy: float
    tests_passed: bool
    test_samples: int = 0
    round_id: int = 0
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


class ScheduleCache:
    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._data: dict[str, list[dict]] = {}
        # bumped on every put; SipKernel instances sharing this store compare
        # it against their resolution memo so a schedule tuned through ONE
        # instance invalidates every other instance's cached resolution
        self.version = 0
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if not isinstance(loaded, dict):
                    raise ValueError(f"expected a JSON object, got "
                                     f"{type(loaded).__name__}")
                for key, entries in loaded.items():
                    if not isinstance(entries, list):
                        raise ValueError(f"entry list for {key!r} is "
                                         f"{type(entries).__name__}")
                    for d in entries:
                        CacheEntry.from_dict(d)   # raises on malformed entry
                self._data = loaded
            except (json.JSONDecodeError, ValueError, TypeError,
                    OSError) as e:
                # a truncated/corrupt store must not take tuning down with
                # it — degrade to empty (the next flush rewrites the file)
                warnings.warn(f"ScheduleCache: ignoring unreadable cache "
                              f"file {path!r} ({e}); starting empty",
                              RuntimeWarning, stacklevel=2)

    @staticmethod
    def key(kernel_name: str, signature: str) -> str:
        return f"{kernel_name}::{signature}"

    def put(self, kernel_name: str, signature: str, schedule: Schedule,
            energy: float, tests_passed: bool, test_samples: int = 0,
            round_id: int = 0, **meta: Any) -> None:
        self.commit([PendingPut(kernel_name=kernel_name, signature=signature,
                                schedule=schedule, energy=energy,
                                tests_passed=tests_passed,
                                test_samples=test_samples, round_id=round_id,
                                meta=meta)])

    def commit(self, puts: Sequence[PendingPut]) -> None:
        """Land a batch of entries atomically: every entry is appended under
        one lock hold, the version bumps ONCE, and the store flushes once
        (write-then-rename, so readers of ``path`` see the old file or the
        whole batch, never a torn state).  An empty batch is a no-op — no
        bump, no flush."""
        if not puts:
            return
        with self._lock:
            for p in puts:
                entry = CacheEntry(schedule_json=p.schedule.to_json(),
                                   energy=p.energy,
                                   tests_passed=p.tests_passed,
                                   test_samples=p.test_samples,
                                   round_id=p.round_id, meta=dict(p.meta))
                self._data.setdefault(self.key(p.kernel_name, p.signature),
                                      []).append(entry.to_dict())
            self.version += 1
            self._flush()

    def changed_since(self, version: int) -> bool:
        """True when the store has committed anything after ``version`` — the
        O(1) check engines run per step to detect a hot-swapped schedule
        (capture ``cache.version``, later ask ``cache.changed_since(v)``)."""
        return self.version != version

    def best(self, kernel_name: str, signature: str) -> Schedule | None:
        """Greedy rank: among all rounds, the lowest-energy entry that passed
        all tests (paper §4.1)."""
        entries = [CacheEntry.from_dict(d)
                   for d in self._data.get(self.key(kernel_name, signature), [])]
        passing = [e for e in entries if e.tests_passed]
        if not passing:
            return None
        best = min(passing, key=lambda e: e.energy)
        return Schedule.from_json(best.schedule_json)

    def entries(self, kernel_name: str, signature: str) -> list[CacheEntry]:
        return [CacheEntry.from_dict(d)
                for d in self._data.get(self.key(kernel_name, signature), [])]

    def drop(self, kernel_name: str, signature: str) -> int:
        """Remove every entry for one (kernel, signature) key.  Returns the
        number of entries removed.  Used by crash-safe tuning: a resumed
        session purges the partial rounds of the workload that was
        in-flight when the previous session died, then re-runs it from its
        deterministic seed — the store converges to exactly what an
        uninterrupted session would have written."""
        with self._lock:
            removed = self._data.pop(self.key(kernel_name, signature), None)
            if removed:
                self.version += 1
                self._flush()
        return len(removed) if removed else 0

    def _flush(self) -> None:
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".sipcache")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
