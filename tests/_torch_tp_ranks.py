"""Rank functions of the port's tensor-parallel CPU tests.

``repro_torch.dist.spawn.run`` starts every rank in a fresh process that
imports its function by name, so the functions live here, in a module that
imports neither JAX nor the JAX package: each rank then pays only for
``torch`` and ``repro_torch``.  Arguments and results are numpy arrays and
plain Python values.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.autotune import Staging
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.core.cache import ScheduleCache
from repro_torch.core.registry import registry, schedule_cache
from repro_torch.dist import collectives, partition, tp
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ContinuousEngine


def collectives_and_parity(rank: int, xs: list[np.ndarray], block: int,
                           params_np, cfg, tokens: np.ndarray, max_len: int,
                           n_decode: int) -> dict:
    """compressed_all_reduce of this rank's ``xs[rank]`` (float32 and
    bfloat16), then greedy prefill + ``n_decode`` decode steps of ``cfg``
    sharded over the job (exact seams) and a prefill with compressed
    seams."""
    mesh = mesh_lib.mesh_for((dist.get_world_size(),), ("model",))
    x = torch.from_numpy(xs[rank])
    out32 = collectives.compressed_all_reduce(x, mesh.group("model"), block)
    out16 = collectives.compressed_all_reduce(x.bfloat16(),
                                              mesh.group("model"), block)
    n = mesh.shape["model"]
    params = tp.tp_shard(params_from_numpy(params_np, cfg, device="cpu"),
                         M.param_logical_axes(cfg), mesh.coord("model"), n)
    local = tp.local_config(cfg, n)
    inputs = {"tokens": torch.as_tensor(tokens)}
    with torch.inference_mode(), tp.tp_context(mesh.group("model")):
        logits, caches = M.prefill(params, inputs, local, max_len=max_len)
        prefill_logits = logits.numpy().copy()
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(n_decode):
            logits, caches = M.decode_step(params, caches, toks[-1], local)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
    with torch.inference_mode(), tp.tp_context(mesh.group("model"),
                                               compressed=True):
        compressed, _ = M.prefill(params, inputs, local, max_len=max_len)
    return {"f32": out32.numpy(), "bf16_dtype": str(out16.dtype),
            "bf16": out16.float().numpy(),
            "tokens": torch.stack(toks, 1).numpy(),
            "last_logits": logits.numpy(), "prefill_logits": prefill_logits,
            "compressed_logits": compressed.numpy()}


def mesh_axes(rank: int, shape: tuple, axes: tuple) -> dict:
    """A mesh over the job: each axis group's sum of the ranks on it, this
    rank's coordinates, and what the production mesh says of this job."""
    mesh = mesh_lib.mesh_for(shape, axes)
    sums = {}
    for axis in axes:
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.group(axis))
        sums[axis] = t.item()
    try:
        mesh_lib.make_production_mesh()
        production = "built"
    except ValueError as e:
        production = str(e)
    host = mesh_lib.make_host_mesh()
    return {"shape": mesh.shape, "axis_names": mesh.axis_names,
            "coords": {a: mesh.coord(a) for a in axes}, "sums": sums,
            "backend": mesh.backend, "device": str(mesh.device),
            "chips": mesh_lib.chips(mesh), "production": production,
            "host_shape": host.shape,
            "broadcast": mesh.broadcast_int(100 + rank, axes[-1])}


def raises_on_rank_1(rank: int) -> None:
    """Rank 1 fails while rank 0 waits in a collective for it."""
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    dist.all_reduce(torch.ones(1))


def desync(rank: int) -> None:
    """Rank 0 enters an all-reduce that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(4))


def sleeps(rank: int, seconds: float) -> None:
    time.sleep(seconds)


def serve_runs(rank: int, cases: list[dict]) -> list[dict]:
    """Each case: a config, its numpy params, requests ``(prompt, budget,
    extra)``, and runs ``(ServeConfig, order)``; every run is a fresh
    tensor-parallel ContinuousEngine over the job's ranks, its requests
    submitted in ``order`` ("fifo" or "reversed").  -> per case, per run,
    the tokens of every request by its index, and the engine's stats."""
    mesh = mesh_lib.mesh_for((dist.get_world_size(),), ("model",))
    out = []
    for case in cases:
        cfg = case["cfg"]
        params = params_from_numpy(case["params"], cfg, device="cpu")
        runs = []
        for scfg, order in case["runs"]:
            eng = ContinuousEngine(params, cfg, scfg, mesh=mesh)
            idxs = list(range(len(case["requests"])))
            if order == "reversed":
                idxs.reverse()
            uid_to_idx = {}
            for i in idxs:
                prompt, budget, extra = case["requests"][i]
                uid_to_idx[eng.submit(prompt, budget, extra=extra).uid] = i
            got = eng.run(max_steps=1000)
            runs.append({"tokens": {i: got[u].tolist()
                                    for u, i in uid_to_idx.items()},
                         "kv_heads": int(eng.caches["k"].shape[-2]),
                         "tp_path": eng.tp_path})
        out.append(runs)
    return out


def _resident_blocks(eng, params) -> dict:
    """Whether every leaf the GSPMD-path engine ``eng`` keeps is its
    ``NamedSharding.local`` block: each param leaf that of the whole
    ``params``, each cache leaf of its block's shape; and how many leaves
    are cut, and the elements kept against the whole model's."""
    ok, cut, kept, total = True, 0, 0, 0
    for sh, leaf, full in zip(flatten(eng.layout.params).values(),
                              flatten(eng.params).values(),
                              flatten(params).values()):
        ok &= torch.equal(leaf, sh.local(full))
        cut += not sh.replicated
        kept, total = kept + leaf.numel(), total + full.numel()
    for sh, leaf in zip(flatten(eng.layout.caches).values(),
                        flatten(eng.caches).values()):
        ok &= tuple(leaf.shape) == sh.local_shape
        cut += not sh.replicated
    return {"blocks_ok": bool(ok), "cut_leaves": cut,
            "param_share": kept / total}


def serve_gspmd_runs(rank: int, cases: list[dict],
                     swap: tuple | None = None) -> dict:
    """Each case: a config, its numpy params, requests ``(prompt, budget,
    extra)``, the engine's ``example_extra`` and runs ``(ServeConfig,
    order)``; every run is a fresh ContinuousEngine over the job's ranks.
    -> ``runs``: per case, per run, the tokens of every request by its
    index, the path taken and why, and (GSPMD path) what
    ``_resident_blocks`` says, the seams its split cuts and its cache
    leaves' shapes; ``swap``: ``staged_swap(rank, *swap)``'s
    result, when ``swap`` is given."""
    mesh = mesh_lib.mesh_for((dist.get_world_size(),), ("model",))
    out = []
    for case in cases:
        cfg = case["cfg"]
        params = params_from_numpy(case["params"], cfg, device="cpu")
        runs = []
        for scfg, order in case["runs"]:
            eng = ContinuousEngine(params, cfg, scfg, mesh=mesh,
                                   example_extra=case.get("example_extra"))
            idxs = list(range(len(case["requests"])))
            if order == "reversed":
                idxs.reverse()
            uid_to_idx = {}
            for i in idxs:
                prompt, budget, extra = case["requests"][i]
                uid_to_idx[eng.submit(prompt, budget, extra=extra).uid] = i
            got = eng.run(max_steps=1000)
            run = {"tokens": {i: got[u].tolist()
                              for u, i in uid_to_idx.items()},
                   "tp_path": eng.tp_path, "tp_reason": eng.tp_reason}
            if eng.layout is not None:
                split = eng.layout.split
                run.update(_resident_blocks(eng, params),
                           gathered_bytes=eng.layout.gathered_bytes,
                           split_cut=sorted(split.cut) if split else [],
                           cache_shapes={k: tuple(v.shape) for k, v in
                                         flatten(eng.caches).items()})
            runs.append(run)
        out.append(runs)
    return {"runs": out,
            "swap": None if swap is None else staged_swap(rank, *swap)}


class PromoteAt(Staging):
    """The first rank's staging, with ``puts`` staged just before the
    ``at``-th step boundary takes it (as a service cycle would stage a
    promotion between two steps)."""

    def __init__(self, at: int, puts):
        super().__init__()
        self.at, self.puts, self.calls = at, puts, 0

    def take(self):
        self.calls += 1
        if self.calls == self.at:
            self.commit(self.puts)
        return super().take()


def staged_swap(rank: int, cfg, params_np, prompts, budgets, scfg,
                puts, at: int) -> dict:
    """``launch.serve.drive_continuous`` over the job's ranks with the
    ``--autotune`` step-boundary sync: the first rank stages ``puts``
    before boundary ``at`` and every rank applies them to its own store.
    -> the tokens by request, the swaps and the step each came at, the
    store's version and the schedules the promoted signatures resolve."""
    mesh = mesh_lib.mesh_for((dist.get_world_size(),), ("model",))
    params = params_from_numpy(params_np, cfg, device="cpu")
    store = ScheduleCache()
    staging = PromoteAt(at, puts) if rank == 0 else None
    tracer = obs.Tracer()
    traffic = [serve_cli.TrafficSpec(len(p), b, 0.0)
               for p, b in zip(prompts, budgets)]
    tokens: dict[int, list[int]] = {}
    with schedule_cache(store), obs.tracing(tracer):
        eng = ContinuousEngine(
            params, cfg, scfg, mesh=mesh,
            on_token=lambda req, tok: tokens.setdefault(req.uid,
                                                        []).append(tok))
        serve_cli.drive_continuous(
            eng, traffic, prompts, mesh=mesh,
            sync=serve_cli.schedule_sync(mesh, store, staging))
    swaps = [e["args"] for e in tracer.events()
             if e["name"] == "serve.schedule_swap"]
    return {"tokens": tokens, "swaps": eng.stats["schedule_swaps"],
            "swap_steps": [a["step"] for a in swaps],
            "version": store.version, "tp_path": eng.tp_path,
            "resolved": [dict(registry.get(p.kernel_name, store)
                              .schedule_for(json.loads(p.signature)).knobs)
                         for p in puts]}


def layer_gathers(rank: int, cfgs: list, tokens_np: np.ndarray,
                  max_len: int, extra_np: dict | None = None) -> list[dict]:
    """For each config (one a depth), ``steps.prefill_step`` then
    ``steps.serve_step`` of ``tokens_np`` (and the batch's ``extra_np``
    inputs: an encoder-decoder's ``enc_embeds``) over the job's ranks on
    a ``("model",)`` mesh, from seed-0 weights cut to this rank's blocks,
    each counted by the dry run's ``StepCounter`` -> per config and step,
    the bytes its layout recorded as gathered and its collectives' bytes
    by op, and the prefill's caches' shapes."""
    mesh = mesh_lib.mesh_for((dist.get_world_size(),), ("model",))
    out = []
    for cfg in cfgs:
        layout = steps.serve_layout(cfg, mesh, tokens_np.shape[0], max_len)
        params = partition.local_tree(M.init_lm(cfg, seed=0, device="cpu"),
                                      layout.params)
        batch = {"tokens": torch.from_numpy(tokens_np),
                 **{k: torch.from_numpy(v)
                    for k, v in (extra_np or {}).items()}}
        box, res = {}, {}

        def prefill():
            box["pre"] = steps.prefill_step(params, batch, cfg=cfg,
                                            max_len=max_len, mesh=mesh,
                                            layout=layout)
        counts = dryrun.count(prefill, (params, batch), mesh)
        res["prefill"] = {"gathered": layout.gathered_bytes,
                          "collectives": counts["collective_bytes"]}
        logits, caches = box["pre"]
        res["cache_shapes"] = {k: tuple(v.shape)
                               for k, v in flatten(caches).items()}
        first = logits.argmax(-1).to(torch.int32)
        layout.gathered_bytes = 0
        counts = dryrun.count(lambda: steps.serve_step(
            params, caches, first, cfg=cfg, mesh=mesh, layout=layout),
            (params, caches, first), mesh)
        res["decode"] = {"gathered": layout.gathered_bytes,
                         "collectives": counts["collective_bytes"]}
        out.append(res)
    return out
