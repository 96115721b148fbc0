"""Training launcher, supervised and fault-tolerant (the port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --steps 4 --batch 8 --seq 32 --ckpt-dir /tmp/ck

Runs on the card unless ``--device cpu``; there the one-device step is a
captured CUDA graph (``train.graphs.TrainGraph``) unless
``--no-step-graphs``.  Every run goes through the
:class:`~repro_torch.ft.Supervisor`: the loop checkpoints (async by
default), heartbeats to the FT manager, and on worker death, non-finite
loss or elastic capacity loss the supervisor restores from the newest
verified checkpoint and re-enters with bounded backoff.

``--mesh host`` trains sharded over ``--ranks`` processes on this host
(default: one a CUDA device), started by ``repro_torch.dist.spawn`` (NCCL
when every rank has a card of its own, else gloo), on a ``(ranks / N,
N)`` ``("data", "model")`` mesh, N ``--model-ranks`` (default 1: the
params' embed dim cut over data, compute replicated); along ``"model"``
each rank runs its heads, MLP hidden dim and vocab block
(``steps.model_split``); an elastic reshape rebuilds the mesh from the
FT manager's ladder on every rank, and rank 0 prints.  ``--mesh single``
and ``multi`` are the reference's pod meshes, (16, 16) and (2, 16, 16):
they need 256 and 512 ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --mesh host --ranks 2 --steps 4 \
        [--model-ranks 2]

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

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import spawn
from repro_torch.ft import (ChaosEngine, FaultPlan, FTConfig, FTManager,
                            RestartBudgetExhausted, Supervisor,
                            SupervisorConfig)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.train.loop import DEFAULT_CKPT_DIR, TrainConfig, train

#: ranks each production mesh needs
PRODUCTION_RANKS = {"single": 256, "multi": 512}


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
    ap.add_argument("--no-step-graphs", action="store_true",
                    help="dispatch the one-device step eagerly (default on "
                         "CUDA: a captured CUDA graph, replayed)")
    ap.add_argument("--mesh", default="none", choices=["none", "host",
                                                       "single", "multi"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of a --mesh job (default: "
                         "torch.cuda.device_count())")
    # --- fault tolerance -------------------------------------------------
    ap.add_argument("--model-ranks", type=int, default=1, metavar="N",
                    help="--mesh host: the 'model' axis of the (ranks/N, "
                         "N) mesh")
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
    if args.mesh == "none":
        return run(args)
    ranks = args.ranks if args.ranks is not None \
        else torch.cuda.device_count()
    need = PRODUCTION_RANKS.get(args.mesh, ranks)
    if ranks < 1 or ranks != need:
        raise ValueError(f"--mesh {args.mesh} needs {need} ranks "
                         f"(make_production_mesh), the job has {ranks}"
                         if args.mesh in PRODUCTION_RANKS else
                         f"--mesh host needs at least one rank: pass "
                         f"--ranks on a host with no CUDA device")
    codes = spawn.run(_train_rank, ranks, args=(args,), device=args.device,
                      timeout_s=mesh_lib.MESH_TIMEOUT_S,
                      deadline_s=float("inf"))
    return max(codes)


def _train_rank(rank: int, args) -> int:
    """One rank of a ``--mesh`` job: its mesh over the job, then
    :func:`run`."""
    if args.mesh == "host":
        mesh = mesh_lib.make_host_mesh(args.model_ranks)
    else:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi")
    return run(args, mesh)


def run(args, mesh: mesh_lib.Mesh | None = None) -> int:
    """Train as ``args`` say (on one rank of ``mesh`` when it is given)
    -> the exit code; on a mesh only its first rank prints."""
    lead = mesh is None or mesh.rank == 0
    mcfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab=mcfg.vocab)
    tcfg = TrainConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       async_ckpt=not args.blocking_ckpt,
                       num_microbatches=args.microbatches,
                       device=args.device,
                       step_graphs=False if args.no_step_graphs else None)
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
        if lead:
            print(f"[train] chaos plan: {[f.to_spec() for f in plan.faults]}")

    sup = Supervisor(
        functools.partial(train, mcfg, dcfg, tcfg, ocfg, ft=ft, chaos=chaos),
        ft=ft, chaos=chaos, mesh=mesh,
        mesh_factory=None if mesh is None
        else lambda target: mesh_lib.mesh_for(*target),
        cfg=SupervisorConfig(max_restarts=args.max_restarts,
                             backoff_base_s=args.backoff_base,
                             backoff_max_s=args.backoff_max))
    try:
        res = sup.run()
    except RestartBudgetExhausted as e:
        print(f"[train] FAILED: {e}")
        return 1
    if res.get("outside_mesh"):
        return 0
    s = res["supervisor"]
    if lead:
        mesh_note = (f" mesh={list(s['final_mesh'][0])}"
                     if s["final_mesh"] else "")
        print(f"[train] done: final loss {res['final_loss']:.4f} at step "
              f"{res['step']}; attempts={s['attempts']} "
              f"recoveries={[e['kind'] for e in s['events']] or 'none'} "
              f"skipped_data_steps={s['skip_data_steps'] or 'none'}"
              f"{mesh_note}")
    if res["step"] < args.steps:
        print(f"[train] FAILED: stopped at step {res['step']} < {args.steps}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
