"""WorkloadRecorder — record the live serving mix, replay it into tuning.

The serve engine sees the *actual* deployment distribution — prompt lengths,
dtypes, batch occupancy at each prefill and decode step — which is exactly
the workload set offline tuning should optimize for (ROADMAP: always-on
autotuning).  A :class:`WorkloadRecorder` hooked into ``ContinuousEngine``
logs one record per prefill/decode dispatch to a replayable JSONL; the
aggregated mix converts into :class:`~repro_torch.core.registry.Workload`
entries (via a caller-supplied args adapter, since each kernel takes its
own argument shapes) that ``TuningSession.run_workload`` consumes directly.
Records and files are the JAX package's, field for field.

Round trip::

    rec = WorkloadRecorder()
    eng = ContinuousEngine(params, cfg, recorder=rec)
    ... serve traffic ...
    rec.save("live.jsonl")

    rec = WorkloadRecorder.load("live.jsonl")
    wls = rec.to_workloads(my_args_for)         # -> list[Workload]
    for wl in wls:
        session.run_workload("my_kernel", wl)
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadKey:
    """Aggregation key for one observed dispatch shape."""

    kind: str            # "prefill" | "decode"
    prompt_len: int      # tokens per row at prefill; 0 for decode
    batch: int           # dispatch batch (prefill group / occupied slots)
    dtype: str

    @property
    def name(self) -> str:
        return f"live_{self.kind}_p{self.prompt_len}_b{self.batch}_{self.dtype}"


class WorkloadRecorder:
    """Thread-safe recorder of the live (shape, dtype, occupancy) mix.

    Raw records are kept up to ``max_records`` (and streamed to
    ``jsonl_path`` as they arrive, when given); the per-key aggregation in
    :meth:`mix` is always complete regardless of the raw-record cap.
    """

    def __init__(self, jsonl_path: str | None = None, *,
                 max_records: int = 1_000_000):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._counts: dict[WorkloadKey, int] = {}
        self._last_t: dict[WorkloadKey, float] = {}
        self.dropped = 0
        self.max_records = max_records
        self._file = open(jsonl_path, "w") if jsonl_path else None

    def record(self, kind: str, *, prompt_len: int = 0, batch: int = 1,
               dtype: str = "int32", occupancy: int = 0,
               queue_depth: int = 0, new_tokens: int = 0,
               t: float | None = None) -> None:
        rec = {"t": round(time.perf_counter() - self._t0, 6)
               if t is None else t,
               "kind": kind, "prompt_len": int(prompt_len),
               "batch": int(batch), "dtype": str(dtype),
               "occupancy": int(occupancy),
               "queue_depth": int(queue_depth),
               "new_tokens": int(new_tokens)}
        key = WorkloadKey(kind=rec["kind"], prompt_len=rec["prompt_len"],
                          batch=rec["batch"], dtype=rec["dtype"])
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._last_t[key] = rec["t"]
            if len(self._records) < self.max_records:
                self._records.append(rec)
            else:
                self.dropped += 1
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")

    # -------------------------------------------------------------- queries
    @property
    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def mix(self) -> dict[WorkloadKey, int]:
        """Observed dispatch mix: key -> occurrence count (complete even
        past the raw-record cap)."""
        with self._lock:
            return dict(self._counts)

    def mix_snapshot(self) -> dict[WorkloadKey, tuple[int, float]]:
        """Drain surface for live consumers (the autotune service): key ->
        (cumulative count, last-seen t).  Like :meth:`mix` this is complete
        past the raw-record cap, so a consumer that diffs successive
        snapshots sees every dispatch — including ones whose raw record was
        dropped — and can staleness-weight each key by when it last fired."""
        with self._lock:
            return {k: (n, self._last_t.get(k, 0.0))
                    for k, n in self._counts.items()}

    @property
    def clock(self) -> float:
        """Seconds since the recorder started — the timebase of every
        record's ``t`` (and of :meth:`mix_snapshot`'s last-seen times)."""
        return time.perf_counter() - self._t0

    def summary(self) -> dict[str, Any]:
        """JSON-able aggregate view (what obsreport renders)."""
        mix = self.mix()
        by_kind = {kind: sum(n for k, n in mix.items() if k.kind == kind)
                   for kind in ("submit", "prefill", "decode")}
        occ = [r["occupancy"] for r in self.records if r["kind"] == "decode"]
        return {
            "records": sum(mix.values()), "dropped": self.dropped,
            "submitted": by_kind["submit"],
            "prefill_dispatches": by_kind["prefill"],
            "decode_steps": by_kind["decode"],
            "mean_decode_occupancy": float(np.mean(occ)) if occ else 0.0,
            "mix": {k.name: n for k, n in
                    sorted(mix.items(), key=lambda kv: -kv[1])},
        }

    # ----------------------------------------------------------- round trip
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    @classmethod
    def load(cls, path: str) -> "WorkloadRecorder":
        rec = cls()
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                rec.record(d["kind"], prompt_len=d.get("prompt_len", 0),
                           batch=d.get("batch", 1),
                           dtype=d.get("dtype", "int32"),
                           occupancy=d.get("occupancy", 0),
                           queue_depth=d.get("queue_depth", 0),
                           new_tokens=d.get("new_tokens", 0),
                           t=d.get("t", 0.0))
        return rec

    def to_workloads(self, args_for: Callable[[WorkloadKey],
                                              Callable[[np.random.Generator],
                                                       Sequence[Any]] | None],
                     *, suites: tuple[str, ...] = ("live",),
                     top: int | None = None) -> list:
        """The recorded mix as TuningSession-ready ``Workload`` entries.

        ``args_for(key)`` maps one observed dispatch shape to the kernel's
        ``make_args(rng)`` callable (each kernel takes its own argument
        shapes, so the adapter is the caller's); returning None skips the
        key.  Keys are ordered by observed frequency; ``top`` bounds how
        many distinct shapes are emitted.
        """
        from repro_torch.core.registry import Workload  # lazy: obs stays light
        out = []
        ranked = sorted(self.mix().items(), key=lambda kv: -kv[1])
        if top is not None:
            ranked = ranked[:top]
        for key, _count in ranked:
            make_args = args_for(key)
            if make_args is None:
                continue
            out.append(Workload(name=key.name, make_args=make_args,
                                suites=suites))
        return out


def tail_jsonl(path: str, offset: int = 0) -> tuple[list[dict], int]:
    """Incrementally read recorder records appended to ``path`` since byte
    ``offset`` — the cross-process drain the autotune daemon uses to follow
    a serving process's ``--record-workloads`` stream.

    Returns ``(records, new_offset)``.  A trailing line without a newline is
    assumed mid-write and left for the next call (its bytes are not
    consumed); a complete-but-corrupt line is skipped, not fatal.  A missing
    file (the server has not started writing yet) yields ``([], offset)``.
    """
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return [], offset
    records: list[dict] = []
    with f:
        f.seek(offset)
        buf = f.read()
    end = buf.rfind(b"\n")
    if end < 0:
        return [], offset
    for line in buf[:end].splitlines():
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return records, offset + end + 1
