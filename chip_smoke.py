"""Chip smoke of the PyTorch/CUDA port: build every kernel, hold each against
its plain version, serve qwen3-1.7b at full width through the paged
continuous engine, and print one JSON line per phase.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; imports only ``repro_torch``
(from ``src/`` beside this file).  Exits non-zero, printing no result, when
there is no card or any phase fails.  The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, obs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pg_ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      ServeConfig)

#: the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: the repo's oracle tolerances: fp32 kernels vs their plain version, and
#: bf16 (TuneConfig.rtol/atol, repro/core/jit.py:43-44)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls, enqueued while a sleep kernel holds the stream, so
    the host's enqueue time does not open gaps between the launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)     # ~25 ms at 2 GHz, longer than the enqueue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of ``fn`` in microseconds (enqueue only;
    the device work is not waited for inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit("device", **info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    fa_lib = _build.load("flash_attention")
    pg_lib = _build.load("paged_gather")
    wall = time.perf_counter() - t0
    del fa_lib, pg_lib
    ptxas = [line.strip() for stem in ("flash_attention", "paged_gather")
             for line in _build.build_log(stem).splitlines()
             if "registers" in line or "spill" in line]
    emit("build", wall_s=wall, ptxas=ptxas)


def _randn(shape, dtype, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def attention_bound_ms(b, hq, hkv, sq, skv, d, esize, causal, window,
                       peak_flops) -> tuple[float, str]:
    rows = np.arange(sq)[:, None] + (skv - sq)
    cols = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    flops = 4.0 * d * int(mask.sum()) * b * hq          # QK^T and PV
    nbytes = esize * d * (2 * b * hq * sq + 2 * b * hkv * skv)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_flash(gen) -> dict:
    cases = [dict(b=2, sq=s, skv=s, causal=True, window=None, d=128)
             for s in (16, 37, 128, 384, 500)]
    cases += [dict(b=2, sq=100, skv=100, causal=False, window=None, d=128),
              dict(b=2, sq=300, skv=300, causal=True, window=64, d=128),
              dict(b=2, sq=37, skv=100, causal=True, window=None, d=128),
              dict(b=3, sq=45, skv=45, causal=True, window=None, d=32),
              dict(b=1, sq=70, skv=70, causal=True, window=None, d=64)]
    results, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn((c["b"], 16, c["sq"], c["d"]), dtype, gen)
            k = _randn((c["b"], 8, c["skv"], c["d"]), dtype, gen)
            v = _randn((c["b"], 8, c["skv"], c["d"]), dtype, gen)
            got = fa.flash_attention(q, k, v, causal=c["causal"],
                                     window=c["window"])
            want = fa_ref.attention(q, k, v, causal=c["causal"],
                                    window=c["window"])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not np.isfinite(err) or err > TOL[dtype]:
                raise AssertionError(f"flash_attention {c} {dtype}: max abs "
                                     f"err {err} > {TOL[dtype]}")
            worst[dtype] = max(worst[dtype], err)
            results.append({**c, "dtype": str(dtype).split(".")[-1],
                            "max_abs_err": err})
    # timing at a prefill shape: B=4, S=384, qwen3 heads, bf16, causal
    b, s, d = 4, 384, 128
    q = _randn((b, 16, s, d), torch.bfloat16, gen)
    k = _randn((b, 8, s, d), torch.bfloat16, gen)
    v = _randn((b, 8, s, d), torch.bfloat16, gen)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    wrapper_us = host_us(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa_ref.attention(q, k, v, causal=True))
    # the library yardstick takes repeated kv heads; the repeat is made
    # outside the timed region
    kr, vr = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(b, 16, 8, s, s, d, 2, True, None,
                                            PEAK_BF16_FLOPS)
    out = {"cases": results, "max_abs_err_f32": worst[torch.float32],
           "max_abs_err_bf16": worst[torch.bfloat16],
           "timed_shape": [b, 16, 8, s, d], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "wrapper_host_us": wrapper_us}
    emit("flash_attention", **out)
    return out


def phase_gather(gen) -> dict:
    store = _randn((257, 16, 8, 128), torch.bfloat16, gen)
    pt = torch.randint(0, 257, (8, 32), generator=gen, device="cuda",
                       dtype=torch.int32)
    pt[0, 0] = 0                    # the trash page
    pt[1, 5] = 0
    pt[3, :4] = pt[2, :4]           # pages shared between slots
    pt[4, 7] = pt[4, 6]             # a page repeated within one row
    got = pg.paged_gather(store, pt)
    want = pg_ref.paged_gather(store, pt)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("paged_gather differs from store[page_table]")
    flat = pt.reshape(-1)
    # the decode step gathers each layer's store after other work, so time
    # with cold L2: 8 stores (67 MB in all) taken in turn
    stores = _randn((8,) + tuple(store.shape), torch.bfloat16, gen)
    turn = itertools.count()

    def cold() -> torch.Tensor:
        return stores[next(turn) % len(stores)]

    ms = cuda_ms(lambda: pg.paged_gather(cold(), pt))
    wrapper_us = host_us(lambda: pg.paged_gather(store, pt))
    plain_ms = cuda_ms(lambda: pg_ref.paged_gather(cold(), pt))
    library_ms = cuda_ms(lambda: torch.index_select(cold(), 0, flat))
    nbytes = pt.numel() * store[0].numel() * store.element_size()
    out = {"store": list(store.shape), "table": list(pt.shape),
           "bitwise_equal": True, "max_abs_err": 0.0, "l2": "cold", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 2 * nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "wrapper_host_us": wrapper_us}
    emit("paged_gather", **out)
    return out


def _serve_requests(vocab: int):
    """16 requests with prompt lengths uniform in 16-384 (request 0: 200),
    and a 17th that begins with request 0's first 64 tokens; new tokens
    uniform in 16-32."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 385, 16)
    lens[0] = 200
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts.append(np.concatenate(
        [prompts[0][:64], rng.integers(0, vocab, 40)]).astype(np.int32))
    return prompts, [int(n) for n in rng.integers(16, 33, len(prompts))]


def _pct_ms(xs, q) -> float:
    return float(np.percentile(xs, q)) * 1e3


def phase_serve(params, cfg) -> dict:
    """The main path: qwen3-1.7b at full width, bf16, on the paged
    continuous engine with prefix sharing and chunked prefill."""
    scfg = ServeConfig(max_len=512, capacity=8, paged=True, page_size=16,
                       prefill_chunk=128, prefix_cache=True)
    prompts, budgets = _serve_requests(cfg.vocab)
    # warm-up on a throwaway engine (cuBLAS handles, allocator), not counted
    warm = ContinuousEngine(params, cfg, scfg)
    for n in (40, 150):
        warm.submit(prompts[1][:n], 2)
    warm.run(max_steps=100)
    del warm
    torch.cuda.synchronize()

    eng = ContinuousEngine(params, cfg, scfg)
    tracer = obs.Tracer()
    fa.launches = 0
    pg.launches = 0
    t0 = time.perf_counter()
    with obs.tracing(tracer):
        handles = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "paged_gather": pg.launches}

    events = tracer.events()
    n_prefill = sum(e["name"] == "serve.prefill" for e in events)
    decode_us = [e["dur"] for e in events if e["name"] == "serve.decode"]
    s = eng.stats
    for r, b in zip(handles, budgets):
        if len(r.tokens) != b:
            raise AssertionError(f"request {r.uid} emitted {len(r.tokens)} "
                                 f"of {b} tokens")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.uid}: token out of range")
    if s["prefix_hits"] < 1 or s["chunk_steps"] < 1:
        raise AssertionError(f"prefix_hits {s['prefix_hits']}, chunk_steps "
                             f"{s['chunk_steps']}: the path was not covered")
    want_pg = 2 * cfg.n_layers * (s["decode_steps"] + s["chunk_steps"])
    want_fa = cfg.n_layers * n_prefill
    if launches != {"flash_attention": want_fa, "paged_gather": want_pg}:
        raise AssertionError(f"launches {launches}, expected flash "
                             f"{want_fa} and gather {want_pg}")
    if n_prefill < 1:
        raise AssertionError("no whole-prompt prefill dispatch ran")
    if eng.pages.used_pages != len(eng.prefix):
        raise AssertionError("pages leaked past the prefix cache's refs")
    ttft = [r.admitted_at - r.submitted_at for r in handles]
    tokens = sum(len(r.tokens) for r in handles)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "requests": len(handles), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_ms": _pct_ms(ttft, 50), "ttft_p99_ms": _pct_ms(ttft, 99),
           "decode_step_p50_ms": float(np.percentile(decode_us, 50)) / 1e3,
           "prefill_s": s["prefill_s"], "decode_s": s["decode_s"],
           "prefill_frac": eng.metrics()["prefill_frac"],
           "prefill_dispatches": n_prefill, "chunk_steps": s["chunk_steps"],
           "decode_steps": s["decode_steps"],
           "prefix_hits": s["prefix_hits"],
           "prefix_tokens_saved": s["prefix_tokens_saved"],
           "prefill_compiles": s["prefill_compiles"], "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("serve", **out)
    return out


def phase_profile(params, cfg) -> dict:
    """Device time by kernel over a short paged serving window (8 requests
    of 100 tokens, 16 new each), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=512, capacity=8, paged=True, page_size=16, prefill_chunk=128))
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab, 100).astype(np.int32), 16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host_ops = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type.name == "CUDA":
            rows.append((dev_us, ev.count, ev.key[:90]))
        elif ev.device_type.name == "CPU" and ev.key.startswith("aten::"):
            host_ops.append((ev.self_cpu_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    host_ops.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    s = eng.stats
    out = {"window": "8 x 100-token prompts, 16 new tokens, paged",
           "wall_s": wall, "device_busy_s": busy_s if rows else None,
           "device_idle_share": 1 - busy_s / wall if rows else None,
           "decode_steps": s["decode_steps"],
           "kernel_launches": sum(r[1] for r in rows),
           "top_kernels": [{"name": k, "calls": c, "ms": us / 1e3}
                           for us, c, k in rows[:12]],
           "top_host_ops": [{"op": k, "calls": c, "self_cpu_ms": us / 1e3}
                            for us, c, k in host_ops[:12]]}
    emit("profile", **out)
    return out


def phase_differential() -> dict:
    """Full width, 4 layers, float32: the paged continuous engine is
    token-identical to single-request Engine.generate, in fifo and reversed
    arrival."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=4,
                              dtype="float32")
    params = M.init_lm(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (23, 70, 16, 45, 70)]
    prompts[4] = np.concatenate([prompts[1][:40],
                                 prompts[4][40:]]).astype(np.int32)
    budgets = [10, 8, 12, 9, 11]
    ref = Engine(params, cfg, ServeConfig(max_len=128))
    want = [ref.generate(p[None], b)[0] for p, b in zip(prompts, budgets)]
    scfg = ServeConfig(max_len=128, capacity=3, paged=True, page_size=16,
                       prefill_chunk=32, prefix_cache=True)
    stats = {}
    for order in ("fifo", "reversed"):
        idxs = list(range(len(prompts)))[::-1 if order == "reversed" else 1]
        eng = ContinuousEngine(params, cfg, scfg)
        uids = {eng.submit(prompts[i], budgets[i]).uid: i for i in idxs}
        got = eng.run(max_steps=1000)
        for uid, i in uids.items():
            if not np.array_equal(got[uid], want[i]):
                raise AssertionError(f"differential ({order}): request {i} "
                                     f"gave {got[uid].tolist()}, Engine "
                                     f"gave {want[i].tolist()}")
        stats[order] = {k: eng.stats[k] for k in (
            "prefix_hits", "chunk_steps", "decode_steps", "prefill_compiles")}
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(prompts), "token_identical": True, **stats}
    emit("differential", **out)
    return out


def kernels_line(flash: dict, gather: dict, serve: dict) -> dict:
    rows = []
    for mod, name, res in ((fa, "flash_attention", flash),
                           (pg, "paged_gather", gather)):
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": mod.REPLACES,
                     "launches": serve["launches"][name],
                     "max_abs_err": res.get("max_abs_err_bf16",
                                            res.get("max_abs_err")),
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    info = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = phase_flash(gen)
    gather = phase_gather(gen)
    cfg = configs.get("qwen3-1.7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve = phase_serve(params, cfg)
    phase_profile(params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_differential()
    print(json.dumps(kernels_line(flash, gather, serve)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
