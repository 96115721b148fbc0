"""Render or validate a repro_torch.obs trace, workload mix or journal.

    PYTHONPATH=src python -m repro_torch.launch.obsreport run_trace.json
    PYTHONPATH=src python -m repro_torch.launch.obsreport run_trace.json \
        --validate
    PYTHONPATH=src python -m repro_torch.launch.obsreport run_trace.json \
        --metrics-json run_metrics.json
    PYTHONPATH=src python -m repro_torch.launch.obsreport live.jsonl \
        --kind workloads
    PYTHONPATH=src python -m repro_torch.launch.obsreport \
        cache.json.autotune.jsonl --kind autotune

Default mode summarizes a Chrome-trace/JSONL file produced by
``launch/tune.py --trace`` or ``launch/serve.py --trace``: top spans by
total time, counter-track extrema (the per-chain energy-vs-step trajectory
of a search run), and — with ``--metrics-json`` — histogram percentiles and
counters from the matching metrics snapshot.  ``--validate`` schema-checks
the file instead (event shape + span nesting, see
``repro_torch.obs.trace.validate_events``) and exits non-zero on any
violation; ``--kind workloads`` treats the file as a ``WorkloadRecorder``
JSONL and summarizes (or validates) the recorded serving mix; ``--kind
autotune`` treats it as an autotune decision journal
(``repro_torch.autotune.log``) and reports promotions (with energy deltas
vs the displaced incumbent), quarantines, warm-start hits, and evictions —
or schema-checks it with ``--validate``.  The files are the JAX package's:
each package's report reads the other's.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.autotune import log as autotune_log
from repro_torch.obs.recorder import WorkloadRecorder
from repro_torch.obs.trace import load_trace, validate_events

_WORKLOAD_KINDS = {"prefill", "decode", "submit"}


def _fmt_ms(us: float) -> str:
    return f"{us / 1e3:10.3f}"


def summarize_spans(events: list[dict], top: int = 15) -> list[str]:
    agg: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            agg.setdefault(ev["name"], []).append(float(ev.get("dur", 0.0)))
    if not agg:
        return ["  (no spans)"]
    lines = [f"  {'span':<28}{'count':>7}{'total ms':>12}{'mean ms':>12}"
             f"{'max ms':>12}"]
    ranked = sorted(agg.items(), key=lambda kv: -sum(kv[1]))[:top]
    for name, durs in ranked:
        lines.append(f"  {name:<28}{len(durs):>7}{_fmt_ms(sum(durs)):>12}"
                     f"{_fmt_ms(sum(durs) / len(durs)):>12}"
                     f"{_fmt_ms(max(durs)):>12}")
    dropped = len(agg) - len(ranked)
    if dropped > 0:
        lines.append(f"  ... {dropped} more span name(s) below the top {top}")
    return lines


def summarize_counters(events: list[dict]) -> list[str]:
    """Counter tracks as (first, min, last) — for an energy track this is
    the energy-vs-step story of the search: where it started, the best it
    found, where it ended."""
    tracks: dict[tuple[str, str], list[float]] = {}
    for ev in events:
        if ev.get("ph") != "C":
            continue
        for key, v in (ev.get("args") or {}).items():
            if isinstance(v, (int, float)):
                tracks.setdefault((ev["name"], key), []).append(float(v))
    if not tracks:
        return ["  (no counter tracks)"]
    lines = [f"  {'track':<40}{'samples':>8}{'first':>10}{'min':>10}"
             f"{'last':>10}"]
    for (name, key), vals in sorted(tracks.items()):
        lines.append(f"  {name + ':' + key:<40}{len(vals):>8}"
                     f"{vals[0]:>10.4g}{min(vals):>10.4g}{vals[-1]:>10.4g}")
    return lines


def summarize_metrics(path: str) -> list[str]:
    with open(path) as f:
        snap = json.load(f)
    lines = []
    for name, m in sorted(snap.items()):
        if m.get("type") == "histogram":
            lines.append(
                f"  {name:<28} n={m['count']:<7} mean={m.get('mean', 0):.4g} "
                f"p50={m.get('p50', 0):.4g} p95={m.get('p95', 0):.4g} "
                f"p99={m.get('p99', 0):.4g} max={m.get('max', 0):.4g}")
        else:
            lines.append(f"  {name:<28} {m.get('type', '?'):<10} "
                         f"{m.get('value', 0):.6g}")
    return lines or ["  (empty snapshot)"]


def validate_workloads(path: str) -> list[str]:
    errors = []
    try:
        with open(path) as f:
            lines = [line for line in f if line.strip()]
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: invalid JSON ({e})")
            continue
        if rec.get("kind") not in _WORKLOAD_KINDS:
            errors.append(f"line {i}: bad kind {rec.get('kind')!r}")
        for field, ty in (("t", (int, float)), ("prompt_len", int),
                          ("batch", int), ("dtype", str),
                          ("occupancy", int), ("queue_depth", int)):
            if not isinstance(rec.get(field), ty):
                errors.append(f"line {i}: bad {field!r}: {rec.get(field)!r}")
    return errors


def summarize_autotune(events: list[dict]) -> list[str]:
    """Activity report for an autotune decision journal: event-kind counts,
    every promotion with its energy delta vs the incumbent it displaced,
    quarantines, warm-start hits, evictions."""
    kinds: dict[str, int] = {}
    for ev in events:
        kinds[str(ev.get("kind", "?"))] = kinds.get(str(ev.get("kind",
                                                              "?")), 0) + 1
    lines = ["  " + "  ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
             if kinds else "  (no events)"]
    promos = [ev for ev in events if ev.get("kind") == "promoted"]
    if promos:
        lines.append(f"  {'kernel':<26}{'workload':<30}{'energy':>11}"
                     f"{'vs incumbent':>14}")
        per_kernel: dict[str, list[float]] = {}
        for ev in promos:
            inc = ev.get("incumbent_energy")
            if isinstance(inc, (int, float)) and inc > 0:
                d = (float(ev.get("energy", 0.0)) / inc - 1.0) * 100
                per_kernel.setdefault(str(ev.get("kernel", "?")),
                                      []).append(d)
                delta = f"{d:+.1f}%"
            else:
                delta = "(untuned)"
            lines.append(f"  {str(ev.get('kernel', '')):<26}"
                         f"{str(ev.get('workload', '')):<30}"
                         f"{float(ev.get('energy', 0.0)):>11.4g}{delta:>14}")
        for kernel, deltas in sorted(per_kernel.items()):
            lines.append(f"  {kernel}: mean energy delta "
                         f"{sum(deltas) / len(deltas):+.1f}% over "
                         f"{len(deltas)} re-promotion(s)")
    for ev in events:
        if ev.get("kind") == "quarantined":
            lines.append(f"  QUARANTINED {ev.get('kernel')}"
                         f"/{ev.get('workload')}: {ev.get('reason')} "
                         f"(max_err={ev.get('max_err', 0)})")
    warm = sum(1 for ev in events if ev.get("kind") == "warm_start")
    evictions = sum(1 for ev in events if ev.get("kind") == "evicted")
    lines.append(f"  warm-start hits: {warm}   evictions: {evictions}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace file (.json Chrome trace or JSONL) "
                                 "or WorkloadRecorder JSONL")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check instead of summarizing; non-zero "
                         "exit on any violation")
    ap.add_argument("--kind", choices=("trace", "workloads", "autotune"),
                    default="trace")
    ap.add_argument("--metrics-json", default=None,
                    help="metrics snapshot to summarize alongside the trace")
    ap.add_argument("--top", type=int, default=15,
                    help="span names to show (by total time)")
    args = ap.parse_args(argv)

    if args.validate:
        if args.kind == "workloads":
            errors = validate_workloads(args.path)
        elif args.kind == "autotune":
            try:
                errors = autotune_log.validate_events(
                    autotune_log.load_events(args.path))
            except (OSError, ValueError) as e:
                errors = [f"{args.path}: unreadable journal ({e})"]
        else:
            try:
                errors = validate_events(load_trace(args.path))
            except (OSError, ValueError, json.JSONDecodeError) as e:
                errors = [f"{args.path}: unreadable trace ({e})"]
        for err in errors[:50]:
            print(f"[obsreport] INVALID: {err}")
        if len(errors) > 50:
            print(f"[obsreport] ... {len(errors) - 50} more errors")
        print(f"[obsreport] {args.path}: "
              f"{'INVALID (%d error(s))' % len(errors) if errors else 'OK'}")
        return 1 if errors else 0

    if args.kind == "workloads":
        rec = WorkloadRecorder.load(args.path)
        print(f"[obsreport] workload mix from {args.path}")
        print(json.dumps(rec.summary(), indent=1))
        return 0

    if args.kind == "autotune":
        events = autotune_log.load_events(args.path)
        print(f"[obsreport] autotune journal {args.path}: "
              f"{len(events)} events")
        for line in summarize_autotune(events):
            print(line)
        return 0

    events = load_trace(args.path)
    print(f"[obsreport] {args.path}: {len(events)} events")
    print("top spans:")
    for line in summarize_spans(events, args.top):
        print(line)
    print("counter tracks (energy-vs-step etc.):")
    for line in summarize_counters(events):
        print(line)
    if args.metrics_json:
        print(f"metrics snapshot ({args.metrics_json}):")
        for line in summarize_metrics(args.metrics_json):
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
