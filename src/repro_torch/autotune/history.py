"""Cross-session tuning history — warm starts and a fitted search policy.

The offline store (:class:`~repro_torch.core.cache.ScheduleCache`)
remembers the *winners*; this journal remembers the *searches*: every gated
candidate the autotune service produced, accepted or not, with the
workload's signature features.  Two things fall out of accumulating that
across sessions:

* **warm starts** — a new workload seeds its search from the accepted
  schedule of its nearest already-tuned neighbor (feature distance over
  shape/dtype), instead of the space default.  Safety: a recalled schedule
  only ever seeds a space it is a legal point of
  (:meth:`SearchSpace.contains`), and its instruction order is kept only on
  an exact signature match — orders are per-program and meaningless across
  shapes (tests/test_torch_autotune.py property-tests both).
* **a fitted policy** — the guided proposal's ``greed`` is fit per kernel on
  the accepted runs' improvements
  (:func:`repro_torch.core.guided.fit_greed`): kernels where greedy
  proposals historically paid off search greedier.

The history file is the JAX package's format (``HISTORY_VERSION`` 1).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Any, Mapping

from repro_torch.core.guided import fit_greed
from repro_torch.core.schedule import Schedule, SearchSpace

HISTORY_VERSION = 1


def features_of(static: Mapping[str, Any]) -> dict[str, float]:
    """A signature dict as a feature vector for nearest-neighbor recall.

    Numeric fields land log2-scaled (a 2048-token prompt should be *near*
    1024, not 1024 units away); booleans are 0/1; any other value (dtype
    strings, window=None) becomes a one-hot ``key:value`` feature, so a
    categorical mismatch costs a fixed distance instead of being dropped.
    """
    feats: dict[str, float] = {}
    for key, value in static.items():
        if isinstance(value, bool):
            feats[f"{key}:{value}"] = 1.0
        elif isinstance(value, (int, float)) and math.isfinite(value):
            feats[key] = math.log2(1.0 + abs(float(value)))
        else:
            feats[f"{key}:{value}"] = 1.0
    return feats


def feature_distance(a: Mapping[str, float], b: Mapping[str, float]) -> float:
    """Euclidean distance over the union of feature keys (absent = 0.0, so a
    one-hot mismatch contributes sqrt(2))."""
    keys = set(a) | set(b)
    return math.sqrt(sum((a.get(k, 0.0) - b.get(k, 0.0)) ** 2 for k in keys))


@dataclasses.dataclass(frozen=True)
class HistoryRecord:
    """One gated search outcome."""

    kernel: str
    signature: str            # SipKernel.sig_str of the tuned workload
    workload: str
    schedule_json: str        # the candidate the search produced
    energy: float
    improvement: float        # AnnealResult.improvement of the run's best
    accepted: bool            # did the promotion gate take it?
    features: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "HistoryRecord":
        return HistoryRecord(**d)


class TuneHistory:
    """Persistent (kernel, signature, schedule, energy) history.

    A single JSON file with atomic replace, like the schedule cache it sits
    next to; an unreadable file degrades to empty rather than taking the
    service down.
    """

    def __init__(self, path: str | None = None, *, max_records: int = 4096):
        self.path = path
        self.max_records = max_records
        self._records: list[HistoryRecord] = []
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    d = json.load(f)
                if d.get("version") == HISTORY_VERSION:
                    self._records = [HistoryRecord.from_dict(r)
                                     for r in d.get("records", [])]
            except (json.JSONDecodeError, OSError, TypeError, ValueError):
                self._records = []

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> list[HistoryRecord]:
        return list(self._records)

    def record(self, *, kernel: str, signature: str, workload: str,
               schedule: Schedule, energy: float, improvement: float,
               accepted: bool, features: Mapping[str, float]) -> HistoryRecord:
        rec = HistoryRecord(kernel=kernel, signature=signature,
                            workload=workload,
                            schedule_json=schedule.to_json(),
                            energy=float(energy),
                            improvement=float(improvement),
                            accepted=bool(accepted),
                            features=dict(features))
        self._records.append(rec)
        if len(self._records) > self.max_records:
            # drop oldest; recent traffic is what warm starts should mirror
            self._records = self._records[-self.max_records:]
        self.save()
        return rec

    # ------------------------------------------------------------- recall
    def warm_start(self, kernel: str, signature: str, space: SearchSpace,
                   features: Mapping[str, float]) -> Schedule | None:
        """The accepted schedule of the nearest tuned neighbor, as a legal
        warm start for ``space`` — or None when no compatible history exists.

        Only records whose knobs are a point of the TARGET space qualify
        (:meth:`SearchSpace.contains`); nearest feature distance among those
        wins, with an exact-signature record beating any neighbor.  The
        instruction order survives only on an exact signature match: orders
        index a specific program's instructions and would be silently
        re-defaulted (at best) against another shape's program.
        """
        best: HistoryRecord | None = None
        best_d = math.inf
        for rec in self._records:
            if rec.kernel != kernel or not rec.accepted:
                continue
            sched = Schedule.from_json(rec.schedule_json)
            if not space.contains(sched.knobs):
                continue
            d = -1.0 if rec.signature == signature \
                else feature_distance(features, rec.features)
            if d < best_d:
                best, best_d = rec, d
        if best is None:
            return None
        sched = Schedule.from_json(best.schedule_json)
        if best.signature != signature:
            sched = dataclasses.replace(sched, order=None)
        return sched

    def greed_for(self, kernel: str, default: float = 0.5) -> float:
        """Guided-policy greed fitted on this kernel's accepted runs."""
        return fit_greed([r.improvement for r in self._records
                          if r.kernel == kernel and r.accepted],
                         default=default)

    # ---------------------------------------------------------------- io
    def save(self) -> None:
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".siphist")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": HISTORY_VERSION,
                           "records": [r.to_dict() for r in self._records]},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
