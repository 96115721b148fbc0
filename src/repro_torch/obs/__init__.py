"""repro_torch.obs — dependency-free telemetry: metrics and tracing.

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` (counters /
  gauges / fixed-bucket histograms) with a contextvar-scoped override.
* :mod:`repro_torch.obs.trace` — structured event :class:`Tracer` with
  nested spans and a Chrome-trace/Perfetto export; ``with tracing(t):``
  activates it, the module-level ``span``/``instant`` helpers are no-ops
  when tracing is off.
* :mod:`repro_torch.obs.recorder` — :class:`WorkloadRecorder`, the live
  serving mix as a replayable JSONL: what the autotune service tunes.

Everything is stdlib (and numpy); nothing here imports torch.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, active_registry,
                                     counter, default_registry,
                                     exponential_edges, gauge, histogram,
                                     metrics_scope)
from repro_torch.obs.recorder import (WorkloadKey, WorkloadRecorder,
                                      tail_jsonl)
from repro_torch.obs.trace import (Tracer, active_tracer, instant,
                                   load_trace, span, tracing,
                                   validate_events, validate_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "active_registry",
    "counter", "default_registry", "exponential_edges", "gauge", "histogram",
    "metrics_scope", "WorkloadKey", "WorkloadRecorder", "tail_jsonl",
    "Tracer", "active_tracer", "instant", "load_trace",
    "span", "tracing", "validate_events", "validate_trace",
]
