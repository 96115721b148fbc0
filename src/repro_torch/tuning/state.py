"""Crash-safe search-state journal for :class:`~repro_torch.tuning.TuningSession`.

A session is a sequence of independently-seeded (kernel, workload) searches;
the journal records, atomically and next to the :class:`ScheduleCache`, which
of them are ``completed``, which one is ``in_progress``, which ``failed``,
and the per-workload quarantine (signatures of candidate schedules whose
evaluation crashed or blew the deadline).  A killed session ``--resume``\\ s
by skipping completed workloads, purging the in-flight workload's partial
cache entries, and re-running it from its deterministic per-workload seed —
so the resumed cache converges to exactly the uninterrupted result.

The write protocol is: ``mark_in_progress`` *before* any tuning work for a
workload, ``mark_completed`` *after* its last cache flush.  Whatever point
the process dies at, the journal's view is pessimistic (a workload is only
``completed`` once all its entries are durably in the cache), which is what
makes the purge-and-rerun recovery correct.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

STATE_VERSION = 1


def state_path_for(cache_path: str) -> str:
    """Default journal location: next to the schedule cache."""
    return cache_path + ".state.json"


@dataclasses.dataclass
class SearchState:
    """On-disk journal; every mutating method persists atomically."""

    path: str
    fingerprint: dict[str, Any] = dataclasses.field(default_factory=dict)
    completed: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    failed: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    in_progress: dict[str, Any] | None = None
    quarantine: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ io
    @classmethod
    def load(cls, path: str) -> "SearchState | None":
        """The journal at ``path``, or None when absent/unreadable (an
        unreadable journal means no resume credit — safe, just slower)."""
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                d = json.load(f)
            if d.get("version") != STATE_VERSION:
                return None
            return cls(path=path,
                       fingerprint=d.get("fingerprint", {}),
                       completed=list(d.get("completed", [])),
                       failed=list(d.get("failed", [])),
                       in_progress=d.get("in_progress"),
                       quarantine={k: list(v) for k, v in
                                   d.get("quarantine", {}).items()})
        except (json.JSONDecodeError, OSError, TypeError, ValueError):
            return None

    def save(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".sipstate")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": STATE_VERSION,
                           "fingerprint": self.fingerprint,
                           "completed": self.completed,
                           "failed": self.failed,
                           "in_progress": self.in_progress,
                           "quarantine": self.quarantine}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------- protocol
    @staticmethod
    def _key(kernel: str, workload: str) -> str:
        return f"{kernel}::{workload}"

    def matches(self, fingerprint: dict[str, Any]) -> bool:
        return self.fingerprint == fingerprint

    def completed_keys(self) -> set[tuple[str, str]]:
        return {(c["kernel"], c["workload"]) for c in self.completed}

    def mark_in_progress(self, kernel: str, workload: str,
                         signature: str) -> None:
        self.in_progress = {"kernel": kernel, "workload": workload,
                            "signature": signature}
        self.save()

    def stale_in_progress(self, kernel: str, workload: str) -> dict | None:
        """The crashed prior run's in-flight record, iff it is this
        workload (the resume must purge its partial cache entries)."""
        ip = self.in_progress
        if ip and ip["kernel"] == kernel and ip["workload"] == workload:
            return ip
        return None

    def mark_completed(self, kernel: str, workload: str, *,
                       signature: str, seed: int,
                       best_energy: float) -> None:
        self.completed.append({"kernel": kernel, "workload": workload,
                               "signature": signature, "seed": seed,
                               "best_energy": best_energy})
        self.in_progress = None
        self.save()

    def mark_failed(self, kernel: str, workload: str, error: str) -> None:
        self.failed.append({"kernel": kernel, "workload": workload,
                            "error": error[:500]})
        self.in_progress = None
        self.save()

    def quarantine_for(self, kernel: str, workload: str) -> set[str]:
        """Caller-owned live set; persist with :meth:`save_quarantine`."""
        return set(self.quarantine.get(self._key(kernel, workload), ()))

    def save_quarantine(self, kernel: str, workload: str,
                        sigs: set[str]) -> None:
        key = self._key(kernel, workload)
        if sigs:
            self.quarantine[key] = sorted(sigs)
        else:
            self.quarantine.pop(key, None)
        self.save()
