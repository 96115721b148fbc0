"""Pair the mamba2-2.7b decode step of checkouts of this repo, in turns, one
process a run, so that host-clock numbers are compared within one machine
and one call.

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/pair_ssm_decode.py step --tree parent=build/parent \\
        --tree this=. --order parent,this,this,parent,parent,this
    python3 tools/pair_ssm_decode.py count --tree parent=build/parent \\
        --tree this=.

Modes:

* ``serve``: each run calls its checkout's ``chip_smoke.phase_serve_ssm``
  (mamba2-2.7b at full width, bf16, seed 0, the contiguous engine) and
  prints its decode step p50, tokens/s and wall time.  Needs a CUDA card.
* ``step``: each run first times the model's ``decode_step`` alone at
  capacity 8 (230 steps, each waited for, the first 30 dropped; then 100
  steps enqueued without waiting), then does what ``serve`` does.
* ``count``: on the CPU, the ATen ops one decode step dispatches at the
  smoke width and 64 layers.  The ops the host issues per step depend on
  neither the device nor the width.

Prints one JSON line per run; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SERVE = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
cs.kernels.load_all()
cfg = cs.configs.get("mamba2-2.7b")
params = cs.M.init_lm(cfg, seed=0, device="cuda")
{step}
cs.phase_serve_ssm(params, cfg)
"""

STEP = """
import json, time
import numpy as np, torch
caches = cs.M.alloc_slot_caches(cfg, 8, 512, device="cuda")
tok = torch.zeros(8, dtype=torch.int32, device="cuda")
ts = []
for _ in range(230):
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs.M.decode_step(params, caches, tok, cfg)
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t)
ts = np.array(ts[30:]) * 1e3
hs = []
for _ in range(100):
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs.M.decode_step(params, caches, tok, cfg)
    hs.append(time.perf_counter() - t)
torch.cuda.synchronize()
print(json.dumps({"step_p50_ms": float(np.median(ts)),
                  "step_mean_ms": float(ts.mean()),
                  "enqueue_p50_ms": float(np.median(hs)) * 1e3}), flush=True)
del caches
"""

COUNT = """
import collections, dataclasses, json, sys
sys.path.insert(0, {src!r})
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import configs
from repro_torch.models import model as M

cfg = dataclasses.replace(configs.get_smoke("mamba2-2.7b"), n_layers=64,
                          dtype="bfloat16")
params = M.init_lm(cfg, seed=0, device="cpu")
caches = M.alloc_slot_caches(cfg, 8, 64, device="cpu")
tok = torch.zeros(8, dtype=torch.int32)


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {{}}))


M.decode_step(params, caches, tok, cfg)
with Count() as count:
    M.decode_step(params, caches, tok, cfg)
print(json.dumps({{"aten_ops": sum(count.ops.values()),
                  "by_op": dict(sorted(count.ops.items()))}}))
"""

KEEP = ("decode_step_p50_ms", "tokens_per_s", "wall_s", "decode_s")


def run(mode: str, root: Path) -> dict:
    if mode == "count":
        code = COUNT.format(src=str(root / "src"))
    else:
        code = SERVE.format(root=str(root),
                            step=STEP if mode == "step" else "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root)
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    if r.returncode or not lines:
        return {"rc": r.returncode, "stderr": r.stderr[-3000:]}
    if mode == "count":
        return lines[-1]
    served = {k: lines[-1][k] for k in KEEP}
    return {**lines[0], **served} if mode == "step" else served


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("serve", "step", "count"))
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path of a checkout (repeat)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, in run order (default: "
                         "each tree once, in the order given)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    out = open(args.out, "w") if args.out else None
    failed = False
    for label in order:
        rec = {"tree": label, **run(args.mode, Path(trees[label]).resolve())}
        failed |= "rc" in rec
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
