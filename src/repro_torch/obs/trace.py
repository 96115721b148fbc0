"""Structured event tracer with nested spans and a Chrome-trace exporter.

A :class:`Tracer` collects timestamped events — complete spans (``ph: "X"``),
instants (``"I"``) and counter samples (``"C"``) — in the Chrome Trace Event
format, so a tune or serve run saved with ``tracer.save("run.json")`` opens
directly in ``ui.perfetto.dev`` / ``chrome://tracing``: spans nest by time
containment per (pid, tid) track, counter tracks plot energy-vs-step or
queue depth over the run.

Event collection is thread-safe (the serve engine emits from its streaming
callback thread); an optional streaming JSONL sink writes each event as one
JSON line the moment it is recorded, so a crashed run still leaves a
readable trace.  ``save`` writes either the Chrome JSON object
(``{"traceEvents": [...]}``, for ``.json`` paths) or JSONL (one event per
line, anything else); :func:`load_trace` and :func:`validate_events` read
and schema-check both forms (``launch/obsreport.py --validate``).

Scoping mirrors :mod:`repro_torch.obs.metrics`: ``with tracing(tracer):`` pushes
the tracer onto a contextvar stack; instrumented code calls the module-level
:func:`span` / :func:`instant` / :func:`counter` helpers, which are cheap
no-ops when no tracer is active — tracing disabled must stay off the serve
hot path.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Iterator

#: event fields beyond these are rejected by the validator
_EVENT_KEYS = {"name", "ph", "ts", "dur", "pid", "tid", "args", "s", "cat"}
_PHASES = {"X", "I", "C", "M"}


class Tracer:
    """Collects Chrome-trace events; see module docstring."""

    def __init__(self, jsonl_path: str | None = None, *,
                 pid: int | None = None):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._pid = os.getpid() if pid is None else pid
        self._file = open(jsonl_path, "w") if jsonl_path else None

    # ------------------------------------------------------------ recording
    def _now_us(self) -> float:
        return round((time.perf_counter() - self._t0) * 1e6, 3)

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            if self._file is not None:
                self._file.write(json.dumps(ev) + "\n")

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[dict]:
        """Complete-event span: emitted on exit with the measured duration.

        Yields the mutable ``args`` dict so the body can attach results
        (``s["tokens"] = n``) that land in the recorded event.
        """
        t0 = self._now_us()
        try:
            yield args
        finally:
            t1 = self._now_us()
            self._emit({"name": name, "ph": "X", "ts": t0,
                        "dur": round(t1 - t0, 3), "pid": self._pid,
                        "tid": threading.get_ident(),
                        "args": _jsonable(args)})

    def instant(self, name: str, **args: Any) -> None:
        self._emit({"name": name, "ph": "I", "ts": self._now_us(), "s": "t",
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": _jsonable(args)})

    def counter(self, name: str, values: dict[str, float]) -> None:
        """One sample on the counter track ``name`` (plots as a time series)."""
        self._emit({"name": name, "ph": "C", "ts": self._now_us(),
                    "pid": self._pid, "tid": 0, "args": _jsonable(values)})

    # -------------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        """Chrome JSON for ``.json`` paths, JSONL otherwise."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.to_chrome(), f)
        else:
            with open(path, "w") as f:
                for ev in self.events():
                    f.write(json.dumps(ev) + "\n")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def _jsonable(d: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in d.items():
        if hasattr(v, "item"):           # numpy scalar
            v = v.item()
        if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
            out[k] = repr(v)             # inf/NaN would break strict JSON
        elif isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


# --------------------------------------------------------------- scoping
_ACTIVE: contextvars.ContextVar[tuple[Tracer, ...]] = \
    contextvars.ContextVar("repro_torch_tracer", default=())


@contextlib.contextmanager
def tracing(tracer: Tracer | None = None) -> Iterator[Tracer]:
    """Activate ``tracer`` (a fresh one when None) for a region of code."""
    tracer = Tracer() if tracer is None else tracer
    token = _ACTIVE.set(_ACTIVE.get() + (tracer,))
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)


def active_tracer() -> Tracer | None:
    """The innermost ``tracing`` scope's tracer, or None (tracing off)."""
    stack = _ACTIVE.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def span(name: str, **args: Any) -> Iterator[dict]:
    """Module-level span helper: records on the active tracer, no-op
    (yielding a throwaway dict the body may still write to) when tracing
    is off."""
    t = active_tracer()
    if t is None:
        yield args
    else:
        with t.span(name, **args) as s:
            yield s


def instant(name: str, **args: Any) -> None:
    t = active_tracer()
    if t is not None:
        t.instant(name, **args)


def counter(name: str, values: dict[str, float]) -> None:
    t = active_tracer()
    if t is not None:
        t.counter(name, values)


# ------------------------------------------------------- load + validation
def load_trace(path: str) -> list[dict]:
    """Events from a Chrome JSON object, a bare JSON array, or JSONL."""
    with open(path) as f:
        text = f.read()
    try:
        loaded = json.loads(text)
    except json.JSONDecodeError:
        # JSONL: every line is its own object (including single-event files,
        # which also parse above — either way the events come out the same)
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(loaded, dict):
        events = loaded.get("traceEvents")
        if isinstance(events, list):
            return events
        if "ph" in loaded:                       # one-line JSONL file
            return [loaded]
        raise ValueError(f"{path}: JSON object without a "
                         f"'traceEvents' list")
    if isinstance(loaded, list):
        return loaded
    return [loaded]


def validate_events(events: list[dict]) -> list[str]:
    """Schema + nesting errors for a trace (empty list == valid).

    Checks each event's shape (known phase, finite non-negative ts/dur,
    required ids) and that "X" spans on each (pid, tid) track nest properly
    by time containment — a child must end no later than its parent, which
    is exactly what Perfetto assumes when it stacks them.
    """
    errors: list[str] = []
    spans: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object: {ev!r}")
            continue
        extra = set(ev) - _EVENT_KEYS
        if extra:
            errors.append(f"event {i}: unknown fields {sorted(extra)}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"event {i}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"event {i}: missing name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"event {i}: missing pid/tid")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X event with bad dur {dur!r}")
                continue
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), ev["name"]))
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"event {i}: C event without args values")
    eps = 0.01                                   # µs; ts is rounded to 1e-3
    for track, evs in spans.items():
        # outermost-first at equal start, then check stack containment
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack: list[tuple[float, float, str]] = []
        for ts, dur, name in evs:
            while stack and stack[-1][0] + stack[-1][1] <= ts + eps:
                stack.pop()
            if stack:
                pts, pdur, pname = stack[-1]
                if ts + dur > pts + pdur + eps:
                    errors.append(
                        f"track {track}: span {name!r} [{ts}, {ts + dur}] "
                        f"overlaps parent {pname!r} [{pts}, {pts + pdur}] "
                        f"without nesting")
            stack.append((ts, dur, name))
    return errors


def validate_trace(path: str) -> list[str]:
    try:
        events = load_trace(path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace ({e})"]
    return validate_events(events)
