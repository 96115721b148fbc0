"""repro_torch.obs — dependency-free telemetry: metrics and tracing.

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` (counters /
  gauges / fixed-bucket histograms) with a contextvar-scoped override.
* :mod:`repro_torch.obs.trace` — structured event :class:`Tracer` with
  nested spans and a Chrome-trace/Perfetto export; ``with tracing(t):``
  activates it, the module-level ``span``/``instant`` helpers are no-ops
  when tracing is off.

Everything is stdlib only.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, active_registry,
                                     counter, default_registry,
                                     exponential_edges, gauge, histogram,
                                     metrics_scope)
from repro_torch.obs.trace import (Tracer, active_tracer, instant,
                                   load_trace, span, tracing,
                                   validate_events, validate_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "active_registry",
    "counter", "default_registry", "exponential_edges", "gauge", "histogram",
    "metrics_scope", "Tracer", "active_tracer", "instant", "load_trace",
    "span", "tracing", "validate_events", "validate_trace",
]
