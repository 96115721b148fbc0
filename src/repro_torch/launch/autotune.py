"""Standalone autotune daemon: tune a live deployment from outside it.

    # terminal 1: serve, streaming the live mix
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --paged --sip-cache build/live_cache.json \
        --record-workloads build/live_mix.jsonl ...

    # terminal 2: the daemon tails the stream and tunes into the same store
    PYTHONPATH=src python -m repro_torch.launch.autotune --arch qwen3-1.7b \
        --paged --cache build/live_cache.json \
        --recorder build/live_mix.jsonl --interval 5 --budget 1

The daemon runs the same
:class:`~repro_torch.autotune.service.AutotuneService` loop
``launch/serve.py --autotune`` embeds, but from a separate process: it
tails the serving process's ``--record-workloads`` JSONL (byte-offset
resume; a mid-write trailing line is left for the next poll), prioritizes
by traffic share x energy headroom, searches in a shadow store, and commits
gate-passing winners to ``--cache``.  A serving process reads that file
when it opens the store, so the daemon's winners serve from its next start;
it hot-swaps only commits made to its own in-memory store (``launch/serve.py
--autotune``), as in the JAX package, whose store does not re-read its file
either.

``--cycles N`` bounds the run (CI smoke); the default (0) runs until
interrupted.  ``--arch``/geometry flags must mirror the serving process so
the adapter maps observed shapes to the kernels that deployment dispatches.
Searches and correctness sweeps run on ``--device`` (default ``cuda``;
asking for CUDA where there is none fails — pass ``--device cpu`` for the
CPU, where each schedule runs its program's torch face).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.autotune import (AutotuneConfig, AutotuneService,
                                  EventLog, TuneHistory, jsonl_source,
                                  serve_targets)
from repro_torch.core.registry import cache_for_path
from repro_torch.serve.engine import ServeConfig
from repro_torch.tuning.state import SearchState


def build_service(args, cfg) -> AutotuneService:
    scfg = ServeConfig(max_len=args.max_len, capacity=args.capacity,
                       paged=args.paged, page_size=args.page_size,
                       num_pages=args.num_pages or None)
    live = cache_for_path(args.cache)
    state_path = args.state or args.cache + ".autotune.state.json"
    state = SearchState.load(state_path) or SearchState(path=state_path)
    acfg = AutotuneConfig(interval_s=args.interval, budget=args.budget,
                          margin=args.margin, samples=args.samples,
                          half_life_s=args.half_life,
                          share_floor=args.share_floor,
                          max_rounds=args.max_rounds, seed=args.seed)
    return AutotuneService(
        live, source=jsonl_source(args.recorder),
        target_for=serve_targets(cfg, scfg), config=acfg,
        history=TuneHistory(args.history or args.cache + ".history.json"),
        state=state,
        log=EventLog(args.log or args.cache + ".autotune.jsonl"),
        device=args.device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.arch_names(),
                    help="the SERVING process's arch (shapes must match)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where searches and sweeps run (cuda or cpu)")
    ap.add_argument("--cache", required=True,
                    help="the deployment's live schedule store (shared with "
                         "the serving process)")
    ap.add_argument("--recorder", required=True,
                    help="the serving process's --record-workloads JSONL to "
                         "tail")
    ap.add_argument("--history", default=None,
                    help="cross-session tune history (default: "
                         "<cache>.history.json)")
    ap.add_argument("--log", default=None,
                    help="decision journal JSONL (default: "
                         "<cache>.autotune.jsonl)")
    ap.add_argument("--state", default=None,
                    help="quarantine/search journal (default: "
                         "<cache>.autotune.state.json)")
    ap.add_argument("--interval", type=float, default=10.0,
                    help="seconds between cycles")
    ap.add_argument("--budget", type=int, default=2,
                    help="workloads tuned per cycle")
    ap.add_argument("--cycles", type=int, default=0,
                    help="stop after N cycles (0 = run until interrupted)")
    ap.add_argument("--margin", type=float, default=0.01,
                    help="relative energy win required to promote")
    ap.add_argument("--samples", type=int, default=8,
                    help="correctness-sweep samples per candidate")
    ap.add_argument("--half-life", type=float, default=120.0,
                    help="traffic staleness half-life, seconds")
    ap.add_argument("--share-floor", type=float, default=0.01,
                    help="evict promoted keys decaying below this share")
    ap.add_argument("--max-rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # serving geometry (mirrors launch/serve.py; feeds the shape adapter)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("autotune: CUDA was asked for and is not available; "
                         "pass --device cpu for the CPU")

    from repro_torch import kernels
    kernels.load_all()
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    svc = build_service(args, cfg)
    print(f"[autotune] daemon over {args.cache} (tailing {args.recorder}, "
          f"interval={args.interval}s, budget={args.budget}/cycle)")
    try:
        if args.cycles > 0:
            for i in range(args.cycles):
                summary = svc.run_once()
                print(f"[autotune] {json.dumps(summary)}")
                if i + 1 < args.cycles:
                    time.sleep(args.interval)
        else:
            svc.start()
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
        svc.log.close()
    print(f"[autotune] done: {json.dumps(svc.metrics())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
