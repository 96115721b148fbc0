"""Deployment correctness gate: probabilistic_test sweep over the registry.

The paper validates every SIP-optimized schedule with 10M random samples
before deployment (§4.2).  This driver is that gate at CI scale: for every
registered kernel workload in ``--suite``, the DEPLOYMENT-path kernel — the
registry-resolved shared instance, serving the tuned schedule when ``--cache``
holds one, the default schedule otherwise — runs against its declared oracle
under a reduced-sample :func:`repro_torch.core.testing.probabilistic_test`.

    PYTHONPATH=src python -m repro_torch.launch.verify --suite smoke --samples 8 \
        --cache /tmp/sip_smoke_cache.json

Kernels run on ``--device`` (default ``cuda``; ``--device cpu`` runs each
program's torch face).  Exits non-zero on any mismatch, so a schedule that
tunes "well" but computes wrong values can never ship.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.registry import registry, schedule_cache, workload_seed
from repro_torch.core.testing import InputSpec, probabilistic_test, to_tensor


def verify_workload(spec, workload, *, samples: int, seed: int,
                    schedule=None, device: str = "cuda") -> dict:
    """Test one (kernel, workload) pair through the deployment path.

    With ``schedule`` (a :class:`~repro_torch.core.schedule.Schedule`) the sweep
    runs a CANDIDATE instead: the kernel is built directly from that
    schedule, bypassing cache resolution — the seam a live
    autotune gate uses to verify a schedule before promotion makes it the
    deployment path."""
    rng = np.random.default_rng(
        workload_seed(spec.name, workload.name, seed) ^ 0x5EED)
    draw = [np.asarray(a) for a in workload.make_args(rng)]
    dtypes = workload.arg_dtypes(draw)
    input_specs = [InputSpec(tuple(a.shape), dt)
                   for a, dt in zip(draw, dtypes)]
    # the signature of the tensors the sweep runs on (a bfloat16 argument's
    # draw is float32 numpy)
    example = [to_tensor(a, dt, "cpu") for a, dt in zip(draw, dtypes)]
    if schedule is not None:
        static = spec.signature_fn(*example)
        fn = spec.build(schedule, **static)
        which = "candidate"
    else:
        kern = registry.get(spec.name)  # honors the active schedule_cache
        static = kern.static_of(*example)
        tuned = kern.cache.best(spec.name, kern.sig_str(static)) is not None
        fn = kern
        which = "tuned" if tuned else "default"
    report = probabilistic_test(fn, spec.oracle, input_specs, samples, rng,
                                device=device)
    return {"kernel": spec.name, "workload": workload.name,
            "schedule": which,
            "passed": report.passed, "samples": report.samples_run,
            "max_err": report.max_err}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=None,
                    help="tuned-schedule store to verify against (default: "
                         "default schedules only)")
    ap.add_argument("--suite", default="smoke",
                    help="workload suite to sweep (default: 'smoke')")
    ap.add_argument("--samples", type=int, default=8,
                    help="probabilistic-test samples per workload (the "
                         "paper's 10M gate, reduced for CI)")
    ap.add_argument("--kernel", action="append", default=[],
                    help="registered kernel name (repeatable; default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("verify: CUDA was asked for and is not available; "
                         "pass --device cpu for the CPU")

    kernels.load_all()
    for name in args.kernel:
        if name not in registry:
            ap.error(f"unknown kernel {name!r}; registered: "
                     f"{', '.join(registry.names())}")

    scope = (schedule_cache(args.cache) if args.cache
             else contextlib.nullcontext())
    ran, failures = 0, []
    with scope:
        for spec in registry.specs():
            if args.kernel and spec.name not in args.kernel:
                continue
            for workload in spec.workloads_in(args.suite):
                res = verify_workload(spec, workload, samples=args.samples,
                                      seed=args.seed, device=args.device)
                ran += 1
                status = "PASS" if res["passed"] else "FAIL"
                print(f"[verify] {status} {res['kernel']}/{res['workload']} "
                      f"({res['schedule']} schedule, {res['samples']} samples,"
                      f" max_err={res['max_err']:.2e})")
                if not res["passed"]:
                    failures.append(res)
    if ran == 0:
        raise SystemExit(f"no {args.suite!r} workloads matched "
                         f"{args.kernel or 'any registered kernel'}")
    if failures:
        names = ", ".join(f"{f['kernel']}/{f['workload']}" for f in failures)
        print(f"[verify] {len(failures)}/{ran} workload(s) FAILED: {names}")
        return 1
    print(f"[verify] {ran} workload(s) passed the correctness gate")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
