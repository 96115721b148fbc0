"""Autotune event journal — the decision audit trail (stdlib-only).

Every consequential decision the always-on service makes — a tuning round, a
promotion, a quarantine, an eviction — lands as one JSONL line, so operators
(and CI) can answer "what did the autotuner do, and why" without attaching a
debugger to a live server.  ``launch/obsreport.py --kind autotune`` renders
and ``--validate``\\ s this file; keeping the module stdlib-only (like the
rest of ``repro_torch.obs``) means that report path never imports torch.
The journal is the JAX package's, line for line: either package's
``obsreport --kind autotune --validate`` accepts the other's file.

Schema: every event carries ``t`` (epoch seconds) and ``kind``; each kind
adds its own required fields (:data:`PER_KIND`).  Extra fields are always
allowed — the schema is a floor, not a ceiling.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

#: every event kind the service emits, with that kind's required fields
PER_KIND: dict[str, dict[str, type | tuple[type, ...]]] = {
    # one per run_once(): the cycle's aggregate outcome
    "cycle": {"cycle": int, "candidates": int, "tuned": int, "promoted": int,
              "quarantined": int},
    # one per tuned (kernel, workload): the search ran, whatever the verdict
    "tuned": {"kernel": str, "workload": str, "energy": (int, float)},
    # gate verdicts
    "promoted": {"kernel": str, "workload": str, "signature": str,
                 "schedule_sig": str, "energy": (int, float)},
    "quarantined": {"kernel": str, "workload": str, "schedule_sig": str,
                    "reason": str},
    "rejected": {"kernel": str, "workload": str, "reason": str},
    # history warm start actually seeded a search
    "warm_start": {"kernel": str, "workload": str},
    # a tuned key's traffic share decayed below the floor
    "evicted": {"kernel": str, "signature": str, "dropped": int},
    # a candidate failed outside the gate (adapter/registry errors)
    "error": {"error": str},
}

KINDS = frozenset(PER_KIND)


class EventLog:
    """Append-only JSONL event journal.

    ``path=None`` keeps events in memory only (tests, dry runs); with a path
    every emit appends one line and flushes, so a crashed service leaves a
    complete journal up to its last decision.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.events: list[dict[str, Any]] = []
        self._file = None
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._file = open(path, "a")

    def emit(self, kind: str, **fields: Any) -> dict[str, Any]:
        if kind not in KINDS:
            raise ValueError(f"unknown autotune event kind {kind!r}; "
                             f"known: {sorted(KINDS)}")
        ev = {"t": round(time.time(), 3), "kind": kind, **fields}
        self.events.append(ev)
        if self._file is not None:
            self._file.write(json.dumps(ev) + "\n")
            self._file.flush()
        return ev

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def load_events(path: str) -> list[dict[str, Any]]:
    """Parse an event JSONL.  Raises ``ValueError`` on a non-JSON line —
    unlike the recorder tail, a torn decision journal should be loud."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: invalid JSON ({e})") from e
    return events


def validate_events(events: Iterable[dict[str, Any]]) -> list[str]:
    """Schema-check a sequence of events; returns human-readable violations
    (empty = valid).  The CI autotune-smoke job gates on this."""
    errors: list[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object: {ev!r}")
            continue
        kind = ev.get("kind")
        if kind not in KINDS:
            errors.append(f"event {i}: bad kind {kind!r}")
            continue
        if not isinstance(ev.get("t"), (int, float)):
            errors.append(f"event {i} ({kind}): bad 't': {ev.get('t')!r}")
        for field, ty in PER_KIND[kind].items():
            if not isinstance(ev.get(field), ty):
                errors.append(f"event {i} ({kind}): bad {field!r}: "
                              f"{ev.get(field)!r}")
    return errors
