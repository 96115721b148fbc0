"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only) and thread-safe: the serve engine records from
its streaming callback thread, the search loop from the tuning thread, and a
snapshot can be taken from either at any time.

Scoping: a process-wide
default :class:`MetricsRegistry` serves production (one long-lived process,
monotonic counters), while ``with metrics_scope() as reg:`` pushes a fresh —
or caller-provided — registry onto a contextvar stack so tests and
concurrent sessions get isolated instruments without touching each other or
the default.  Instrument factories (:func:`counter` & friends and
``MetricsRegistry.counter``) are get-or-create by name, so independent call
sites share one instrument per name within a registry.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import math
import threading
from typing import Iterator, Sequence


class Counter:
    """Monotonic counter (int increments stay int, float make it float)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self.set(0.0)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


def exponential_edges(lo: float, hi: float, n: int) -> tuple[float, ...]:
    """``n`` geometrically spaced bucket edges covering [lo, hi]."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError(f"need 0 < lo < hi and n >= 2, got "
                         f"lo={lo} hi={hi} n={n}")
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``edges`` are the (sorted, finite) bucket upper bounds; values land in
    ``len(edges) + 1`` counts — an implicit underflow bucket below
    ``edges[0]`` is counts[0] and the overflow bucket above ``edges[-1]`` is
    counts[-1], so out-of-range observations are counted, never dropped.
    Percentiles interpolate linearly inside a bucket, clamped to the
    observed min/max for the open-ended end buckets.
    """

    __slots__ = ("name", "edges", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    DEFAULT_EDGES = exponential_edges(1e-5, 100.0, 24)   # seconds-ish scale

    def __init__(self, name: str, edges: Sequence[float] | None = None):
        edges = tuple(edges) if edges is not None else self.DEFAULT_EDGES
        if len(edges) < 1 or list(edges) != sorted(edges) \
                or len(set(edges)) != len(edges) \
                or not all(math.isfinite(e) for e in edges):
            raise ValueError(f"edges must be finite, strictly increasing and "
                             f"non-empty, got {edges!r}")
        self.name = name
        self.edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return                      # inf/NaN would poison sum/percentiles
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated ``q``-th percentile (q in [0, 100]); 0.0 when empty."""
        with self._lock:
            count = self._count
            counts = list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        if count == 0:
            return 0.0
        rank = (q / 100.0) * (count - 1)          # 0-based fractional rank
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c > rank:
                # bucket i spans (edges[i-1], edges[i]]; clamp the open ends
                # to what was actually observed
                lo = self.edges[i - 1] if i > 0 else lo_obs
                hi = self.edges[i] if i < len(self.edges) else hi_obs
                lo = max(lo, lo_obs)
                hi = min(hi, hi_obs)
                frac = (rank - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return hi_obs

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "count": self._count,
                    "sum": self._sum,
                    "min": self._min if self._count else 0.0,
                    "max": self._max if self._count else 0.0,
                    "edges": list(self.edges), "counts": list(self._counts)}

    def snapshot_with_percentiles(self) -> dict:
        d = self.snapshot()
        d.update(p50=self.percentile(50), p95=self.percentile(95),
                 p99=self.percentile(99), mean=self.mean)
        return d


class MetricsRegistry:
    """Name -> instrument, get-or-create, with a JSON-able snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] | None = None) -> Histogram:
        h = self._get(name, Histogram, edges)
        if edges is not None and tuple(edges) != h.edges:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"edges {h.edges!r}")
        return h

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __len__(self) -> int:
        return len(self._instruments)

    def reset(self) -> None:
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst.reset()

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            insts = dict(self._instruments)
        return {name: (inst.snapshot_with_percentiles()
                       if isinstance(inst, Histogram) else inst.snapshot())
                for name, inst in sorted(insts.items())}

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


#: process-wide default — production instruments land here when no scope is
#: active (long-lived process, monotonic counters)
default_registry = MetricsRegistry()

# contextvar stack (not a module global), mirroring registry.schedule_cache:
# concurrent scopes in different threads/tasks must not see each other's
# registry.
_ACTIVE: contextvars.ContextVar[tuple[MetricsRegistry, ...]] = \
    contextvars.ContextVar("repro_torch_metrics_registry", default=())


@contextlib.contextmanager
def metrics_scope(reg: MetricsRegistry | None = None) \
        -> Iterator[MetricsRegistry]:
    """Activate an isolated registry for a region of code.

    ``active_registry()`` calls inside the region resolve ``reg`` (a fresh
    registry when None), so instrumented code — engines, search chains,
    train steps — records there instead of the process default.  Reentrant;
    innermost wins.
    """
    reg = MetricsRegistry() if reg is None else reg
    token = _ACTIVE.set(_ACTIVE.get() + (reg,))
    try:
        yield reg
    finally:
        _ACTIVE.reset(token)


def active_registry() -> MetricsRegistry:
    """The innermost ``metrics_scope`` registry, or the process default."""
    stack = _ACTIVE.get()
    return stack[-1] if stack else default_registry


def counter(name: str) -> Counter:
    return active_registry().counter(name)


def gauge(name: str) -> Gauge:
    return active_registry().gauge(name)


def histogram(name: str, edges: Sequence[float] | None = None) -> Histogram:
    return active_registry().histogram(name, edges)
