"""Training launcher, supervised and fault-tolerant (the port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --steps 4 --batch 8 --seq 32 --ckpt-dir /tmp/ck

Runs on the card unless ``--device cpu``.  Every run goes through the
:class:`~repro_torch.ft.Supervisor`: the loop checkpoints (async by
default), heartbeats to the FT manager, and on worker death, non-finite
loss or elastic capacity loss the supervisor restores from the newest
verified checkpoint and re-enters with bounded backoff.  ``--mesh`` other
than ``none`` raises: the port trains on one device (ROADMAP.md Queue 1
item 2).

``--chaos`` drives the deterministic fault-injection harness, e.g.::

    --chaos 'crash@7,corrupt@5'        # kill at step 7, damage ckpt 5
    --chaos 'kill@10:w1:perm'          # worker 1 dies for good (elastic)
    --chaos 'nan@12:sticky'            # bad batch: nan until skipped
    --chaos 'random:123'               # seeded random plan

Exits non-zero if training does not reach ``--steps`` (restart budget
exhausted)."""

from __future__ import annotations

import argparse
import functools

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft import (ChaosEngine, FaultPlan, FTConfig, FTManager,
                            RestartBudgetExhausted, Supervisor,
                            SupervisorConfig)
from repro_torch.optim import adamw
from repro_torch.train.loop import DEFAULT_CKPT_DIR, TrainConfig, train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.arch_names())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--blocking-ckpt", action="store_true",
                    help="synchronous checkpoint saves (default: overlapped "
                         "async device-to-host + background write)")
    ap.add_argument("--mesh", default="none", choices=["none", "host",
                                                       "single", "multi"])
    # --- fault tolerance -------------------------------------------------
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection plan: comma-separated "
                         "kind@step[:wW][:xF][:dD][:perm][:sticky][:mode] "
                         "with kind in {crash,kill,straggle,nan,corrupt}, "
                         "or random:SEED")
    ap.add_argument("--workers", type=int, default=1,
                    help="logical worker count reported to the FT manager")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--backoff-base", type=float, default=0.05, metavar="S")
    ap.add_argument("--backoff-max", type=float, default=5.0, metavar="S")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    metavar="S")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: repro_torch trains on one device; meshes "
            f"are ROADMAP.md Queue 1 item 2 (distribution)")

    mcfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab=mcfg.vocab)
    tcfg = TrainConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       async_ckpt=not args.blocking_ckpt,
                       num_microbatches=args.microbatches,
                       device=args.device)
    ocfg = adamw.OptConfig(peak_lr=args.lr,
                           warmup_steps=min(100, args.steps // 10 + 1),
                           decay_steps=args.steps)

    ft = FTManager(n_workers=args.workers,
                   cfg=FTConfig(heartbeat_timeout_s=args.heartbeat_timeout,
                                max_restarts=args.max_restarts))
    chaos = None
    if args.chaos:
        plan = FaultPlan.parse(args.chaos, n_workers=args.workers,
                               total_steps=args.steps)
        chaos = ChaosEngine(plan)
        print(f"[train] chaos plan: {[f.to_spec() for f in plan.faults]}")

    sup = Supervisor(
        functools.partial(train, mcfg, dcfg, tcfg, ocfg, ft=ft, chaos=chaos),
        ft=ft, chaos=chaos,
        cfg=SupervisorConfig(max_restarts=args.max_restarts,
                             backoff_base_s=args.backoff_base,
                             backoff_max_s=args.backoff_max))
    try:
        res = sup.run()
    except RestartBudgetExhausted as e:
        print(f"[train] FAILED: {e}")
        return 1
    s = res["supervisor"]
    print(f"[train] done: final loss {res['final_loss']:.4f} at step "
          f"{res['step']}; attempts={s['attempts']} "
          f"recoveries={[e['kind'] for e in s['events']] or 'none'} "
          f"skipped_data_steps={s['skip_data_steps'] or 'none'}")
    if res["step"] < args.steps:
        print(f"[train] FAILED: stopped at step {res['step']} < {args.steps}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
