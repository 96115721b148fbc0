"""repro_torch.autotune — always-on autotuning from live serving traffic.

Closes the record -> tune -> verify -> deploy loop inside one running
deployment: an :class:`AutotuneService` drains the live workload mix, tunes
the busiest shapes in a shadow store, gates every candidate through the
probabilistic correctness sweep plus an energy margin
(:class:`PromotionGate`), and commits survivors to the live
:class:`~repro_torch.core.cache.ScheduleCache` in one atomic batch —
running engines hot-swap schedules before their next dispatch, no restart.

Cross-session memory lives in :class:`TuneHistory` (warm starts from the
nearest tuned neighbor, fitted guided-search greed); every decision is
journaled via :class:`EventLog` for ``launch/obsreport.py --kind autotune``.

On the card the service tunes on a worker thread with a CUDA stream of its
own, so its builds, sweeps and timings never queue behind (or hold up) the
serving thread's kernels.

Exports resolve lazily so torch-free consumers (``obsreport`` validating an
event journal via :mod:`repro_torch.autotune.log`) never pay for the
service's torch-backed modules.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "TuneTarget": "repro_torch.autotune.adapters",
    "serve_targets": "repro_torch.autotune.adapters",
    "GateDecision": "repro_torch.autotune.gate",
    "PromotionGate": "repro_torch.autotune.gate",
    "incumbent_energy": "repro_torch.autotune.gate",
    "TuneHistory": "repro_torch.autotune.history",
    "feature_distance": "repro_torch.autotune.history",
    "features_of": "repro_torch.autotune.history",
    "EventLog": "repro_torch.autotune.log",
    "load_events": "repro_torch.autotune.log",
    "validate_events": "repro_torch.autotune.log",
    "AutotuneConfig": "repro_torch.autotune.service",
    "AutotuneService": "repro_torch.autotune.service",
    "Staging": "repro_torch.autotune.service",
    "apply_staged": "repro_torch.autotune.service",
    "WorkloadDistribution": "repro_torch.autotune.service",
    "jsonl_source": "repro_torch.autotune.service",
    "recorder_source": "repro_torch.autotune.service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__() -> list[str]:
    return __all__
