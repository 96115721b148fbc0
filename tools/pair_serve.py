"""Pair serve paths of checkouts of this repo, in turns, one process a run,
so that host-clock numbers are compared within one machine and one call.

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/pair_serve.py serve --tree parent=build/parent \\
        --tree this=. --order parent,this,this,parent
    python3 tools/pair_serve.py count --tree parent=build/parent \\
        --tree this=.
    python3 tools/pair_serve.py host --tree parent=build/parent \\
        --tree this=. --order this,parent,parent,this
    python3 tools/pair_serve.py gspmd --tree parent=build/parent \\
        --tree this=. --order parent,this,this,parent

Modes:

* ``serve``: each run calls its checkout's ``chip_smoke`` serve phases,
  full width and bf16 as ``chip_smoke.main`` sizes them: ``serve``
  (qwen3-1.7b, paged), ``serve_moe`` (dbrx-132b cut to 8 of 40 layers,
  paged) and ``serve_encdec`` (seamless-m4t-large-v2, contiguous), and
  prints each one's tokens/s, decode step p50 and TTFT.  Needs a CUDA card.
* ``count``: on the CPU, the ATen ops that the same three engines dispatch
  to serve four requests at the smoke width, in total and by op.  The ops
  the host issues depend on neither the device nor the width.
* ``gspmd``: each run calls its checkout's ``chip_smoke`` ``serve_gspmd``
  rank function on 2 ranks sharing the card over gloo (mamba2-2.7b at
  full width, cut as that checkout cuts it, the GSPMD path) and prints
  each rank's decode step p50, GB gathered a dispatch, wall, peak and
  tokens.  Needs a CUDA card; the run's script is written to the
  checkout's ``build/`` (a rank process imports it by path).
* ``host``: on the CPU, qwen3-1.7b's paged engine at the smoke width and
  its full 28 layers, float32, serving the ``count`` prompts three times
  over with 16 new tokens each, on one thread: the p50 of
  the ``serve.decode`` spans, which at this width is mostly the host's
  cost of a step (its Python and dispatch), beside the whole run's wall.

Prints one JSON line per run; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SERVE = """
import dataclasses, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
cs.kernels.load_all()
for arch in ("qwen3-1.7b", "dbrx-132b", "seamless-m4t-large-v2"):
    cfg = cs.configs.get(arch)
    n_full = cfg.n_layers
    if arch == "dbrx-132b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    params = cs.M.init_lm(cfg, seed=0, device="cuda")
    if arch == "qwen3-1.7b":
        cs.phase_serve(params, cfg)
    elif arch == "dbrx-132b":
        cs.phase_serve_moe(params, cfg, n_full)
    else:
        cs.phase_serve_encdec(params, cfg)
    del params
    torch.cuda.empty_cache()
"""

COUNT = """
import collections, json, sys
sys.path.insert(0, {src!r})
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousEngine, ServeConfig


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {{}}))


out = {{}}
for arch, paged in (("qwen3-1.7b", True), ("dbrx-132b", True),
                    ("seamless-m4t-large-v2", False)):
    cfg = configs.get_smoke(arch, dtype="bfloat16")
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    extra = None
    if cfg.family == "enc_dec":
        extra = {{"enc_embeds": rng.standard_normal(
            (cfg.enc_len, cfg.d_model)).astype(np.float32)}}
    scfg = (ServeConfig(max_len=64, capacity=3, paged=True, page_size=8,
                        prefill_chunk=16) if paged
            else ServeConfig(max_len=64, capacity=3))
    eng = ContinuousEngine(params, cfg, scfg, example_extra=extra)
    for n, b in ((5, 6), (20, 4), (9, 7), (20, 5)):
        eng.submit(rng.integers(1, cfg.vocab, n).astype(np.int32), b,
                   extra=extra)
    with Count() as count:
        eng.run(max_steps=500)
    out[arch] = {{"aten_ops": sum(count.ops.values()),
                 "by_op": dict(sorted(count.ops.items()))}}
print(json.dumps(out))
"""

HOST = """
import json, sys, time
sys.path.insert(0, {src!r})
import numpy as np, torch
from repro_torch import configs, obs
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousEngine, ServeConfig

torch.set_num_threads(1)
cfg = configs.get_smoke("qwen3-1.7b", n_layers=28)
params = M.init_lm(cfg, seed=0, device="cpu")
scfg = ServeConfig(max_len=64, capacity=3, paged=True, page_size=8,
                   prefill_chunk=16)
rng = np.random.default_rng(0)
reqs = [rng.integers(1, cfg.vocab, n).astype(np.int32)
        for n in (5, 20, 9, 20)] * 3
for _ in range(2):                 # the first run warms up, untimed
    eng = ContinuousEngine(params, cfg, scfg)
    tracer = obs.Tracer()
    t0 = time.perf_counter()
    with obs.tracing(tracer):
        for p in reqs:
            eng.submit(p, 16)
        eng.run(max_steps=500)
    wall = time.perf_counter() - t0
us = [e["dur"] for e in tracer.events() if e["name"] == "serve.decode"]
print(json.dumps({{"decode_step_p50_ms": float(np.median(us)) / 1e3,
                  "decode_steps": len(us), "wall_s": wall}}))
"""

GSPMD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs

KEEP = ("decode_step_p50_ms", "gathered_gb_per_dispatch", "wall_s",
        "peak_mem_gb", "tokens")


def rank(r):
    out = cs._serve_gspmd_rank(cs._tp_rank_setup(cs.MESH_RANKS))
    return {{k: out[k] for k in KEEP}}


if __name__ == "__main__":
    print(json.dumps({{"ranks": cs.spawn.run(
        rank, cs.MESH_RANKS, device="cuda", timeout_s=cs.TP_TIMEOUT_S,
        deadline_s=cs.MESH_DEADLINE_S)}}))
"""

KEEP = ("tokens_per_s", "decode_step_p50_ms", "ttft_p50_ms", "ttft_p99_ms",
        "wall_s")


def run(mode: str, root: Path) -> dict:
    if mode == "gspmd":
        script = root / "build" / "pair_gspmd.py"
        script.parent.mkdir(exist_ok=True)
        script.write_text(GSPMD.format(root=str(root)))
        cmd = [sys.executable, str(script)]
    else:
        code = (SERVE.format(root=str(root)) if mode == "serve"
                else {"count": COUNT, "host": HOST}[mode].format(
                    src=str(root / "src")))
        cmd = [sys.executable, "-c", code]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    if r.returncode or not lines:
        return {"rc": r.returncode, "stderr": r.stderr[-3000:]}
    if mode != "serve":
        return lines[-1]
    return {rec["phase"]: {k: rec[k] for k in KEEP} for rec in lines
            if rec.get("phase", "").startswith("serve")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("serve", "count", "host", "gspmd"))
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
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
