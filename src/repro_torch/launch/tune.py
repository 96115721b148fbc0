"""Offline SIP search driver over the kernel registry (paper §4.1).

Fully generic: every kernel declares its own deployment workloads next to
its integration module, so this driver contains zero per-kernel code —
adding a kernel (or a deployment shape) never touches this file.

    PYTHONPATH=src python -m repro_torch.launch.tune --list
    PYTHONPATH=src python -m repro_torch.launch.tune --cache sip_cache.json \
        --rounds 2 --kernel gemm_fused_leaky_relu --kernel flash_attention_causal
    PYTHONPATH=src python -m repro_torch.launch.tune --smoke      # CI gate

Kernels run on ``--device`` (default ``cuda``: each schedule is emitted,
compiled and launched on the card; asking for CUDA where there is none
fails).  ``--device cpu`` runs each program's torch face instead.
Serving then activates the persisted store with
``repro_torch.core.schedule_cache(path)`` and resolves tuned kernels by name.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from repro_torch import kernels, obs
from repro_torch.kernels import _build
from repro_torch.core.jit import TuneConfig
from repro_torch.core.registry import registry
from repro_torch.tuning.session import SimulatedCrash, TuningSession
from repro_torch.tuning.state import state_path_for


#: the store a bare ``tune`` writes: inside this checkout's build directory,
#: so two checkouts never read or resume each other's store
DEFAULT_CACHE = _build.BUILD_DIR.parent / "sip_cache.json"


def _print_listing() -> None:
    for spec in registry.specs():
        wls = ", ".join(f"{w.name}({'/'.join(w.suites)})"
                        for w in spec.workloads) or "(no workloads)"
        print(f"{spec.name}  [{spec.module}]")
        print(f"    {wls}")


def _check_smoke_coverage() -> None:
    """Every kernel package must contribute at least one smoke workload —
    a kernel that cannot be smoke-tuned fails the build instead of silently
    dropping out of CI."""
    packages = {s.module.rsplit(".", 1)[0] for s in registry.specs()}
    for pkg in sorted(packages):
        specs = [s for s in registry.specs()
                 if s.module.rsplit(".", 1)[0] == pkg]
        if not any(s.workloads_in("smoke") for s in specs):
            raise SystemExit(f"kernel package {pkg!r} declares no 'smoke' "
                             f"workload; add one to its integration module")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="list registered kernels + workload suites and exit")
    ap.add_argument("--cache", default=str(DEFAULT_CACHE),
                    help=f"schedule store to write (default: {DEFAULT_CACHE}, "
                         f"beside the built kernels)")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (emitted CUDA kernels) "
                         "or cpu (the programs' torch face)")
    ap.add_argument("--kernel", action="append", default=[],
                    help="registered kernel name (repeatable; default: all)")
    ap.add_argument("--suite", default="default",
                    help="workload suite to tune (default: 'default')")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: 1 fast round over every registered "
                         "kernel's tiny 'smoke' workload")
    ap.add_argument("--seed", type=int, default=0,
                    help="session base seed (per-workload seeds derive from "
                         "it, independent of kernel selection/order)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cooling", type=float, default=1.05)
    ap.add_argument("--final-samples", type=int, default=64)
    ap.add_argument("--guided", action="store_true",
                    help="use the beyond-paper guided mutation policy")
    ap.add_argument("--greed", type=float, default=0.5,
                    help="P(greedy proposal) when --guided (default 0.5)")
    ap.add_argument("--chains", type=int, default=1,
                    help="population chains per round on a temperature "
                         "ladder (1 == paper-faithful sequential search)")
    ap.add_argument("--exchange-every", type=int, default=16,
                    help="lockstep rounds between best-state exchanges "
                         "(0 disables migration)")
    ap.add_argument("--no-memoize", action="store_true",
                    help="disable the shared energy cache (re-evaluate "
                         "revisited schedules)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed session from its search-state "
                         "journal: skip completed workloads, purge + re-run "
                         "the one that was in flight")
    ap.add_argument("--state", default=None,
                    help="search-state journal path (default: "
                         "<cache>.state.json)")
    ap.add_argument("--eval-deadline", type=float, default=None,
                    metavar="S",
                    help="wall-clock cap per candidate evaluation; a wedged "
                         "or crashing schedule is quarantined and skipped, "
                         "never fatal")
    ap.add_argument("--keep-going", action="store_true",
                    help="record a workload whose tuning raises as failed "
                         "and continue with the rest of the session")
    ap.add_argument("--die-after", type=int, default=None, metavar="N",
                    help=f"chaos/CI: simulate a crash mid-journal after N "
                         f"workloads (exit code {SimulatedCrash.EXIT_CODE}); "
                         f"recover with --resume")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON of the tuning run "
                         "(per-workload/round spans + per-chain energy "
                         "tracks, for Perfetto)")
    ap.add_argument("--metrics-json", default=None,
                    help="write a metrics-registry snapshot of the run")
    args = ap.parse_args(argv)

    kernels.load_all()
    if args.list:
        _print_listing()
        return 0

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("tune: CUDA was asked for and is not available; "
                         "pass --device cpu for the CPU")
    suite = args.suite
    cfg = TuneConfig(rounds=args.rounds, cooling=args.cooling,
                     final_samples=args.final_samples, step_samples=1,
                     seed=args.seed, guided=args.guided, greed=args.greed,
                     chains=args.chains, exchange_every=args.exchange_every,
                     memoize=not args.no_memoize,
                     eval_deadline_s=args.eval_deadline)
    if args.smoke:
        suite = "smoke"
        # the CI gate pins the budget knobs (fast, fixed cost) but keeps
        # every other flag the user wired in
        cfg = dataclasses.replace(cfg, rounds=1, t_min=0.3, cooling=1.3,
                                  final_samples=4)
        _check_smoke_coverage()

    for name in args.kernel:
        if name not in registry:
            ap.error(f"unknown kernel {name!r}; registered: "
                     f"{', '.join(registry.names())}")

    # pass the path, not a ScheduleCache: the session interns it, so an
    # in-process schedule_cache(args.cache) scope shares the same store
    state = args.state if args.state is not None else state_path_for(args.cache)
    session = TuningSession(cache=args.cache, config=cfg, state=state,
                            keep_going=args.keep_going,
                            die_after=args.die_after, device=args.device)
    tracer = obs.Tracer() if args.trace else None
    with contextlib.ExitStack() as stack:
        if tracer is not None:
            stack.enter_context(obs.tracing(tracer))
        reg = stack.enter_context(obs.metrics_scope()) \
            if args.metrics_json else obs.active_registry()
        with obs.span("tune.session", suite=suite, seed=args.seed):
            try:
                runs = session.run(kernels=args.kernel or None, suite=suite,
                                   verbose=True, resume=args.resume)
            except SimulatedCrash as e:
                print(f"[tune] {e}")
                return SimulatedCrash.EXIT_CODE
    if tracer is not None:
        tracer.save(args.trace)
        print(f"[tune] trace written to {args.trace}")
    if args.metrics_json:
        reg.save_json(args.metrics_json)
        print(f"[tune] metrics snapshot written to {args.metrics_json}")
    if session.failures:
        for f in session.failures:
            print(f"[tune] FAILED {f['kernel']} · {f['workload']}: "
                  f"{f['error']}")
    if not runs and not args.resume:
        raise SystemExit(f"no {suite!r} workloads matched "
                         f"{args.kernel or 'any registered kernel'}")
    print(f"[tune] {len(runs)} workload(s) tuned; schedules persisted to "
          f"{args.cache}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
