"""Chip smoke of the PyTorch/CUDA port: build every emitted kernel, hold each
against its plain version at its default schedule and at seeded random legal
orders, run the SIP loop on the card (smoke tune, verify, a wall-clock tune
of each kernel), serve qwen3-1.7b, dbrx-132b (MoE, 8 of its 40 layers) and
llava-next-34b (VLM, embedding prompts) at full width through the paged
continuous engine, and mamba2-2.7b, zamba2-7b (hybrid) and h2o-danube-1.8b
(sliding window) at full width through the contiguous one, and print one
JSON line per phase.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; imports only ``repro_torch``
(from ``src/`` beside this file).  Exits non-zero, printing no result, when
there is no card or any phase fails.  The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import io
import itertools
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, kernels, obs  # noqa: E402
from repro_torch.autotune import (AutotuneConfig, AutotuneService,  # noqa: E402
                                  EventLog, load_events, recorder_source,
                                  serve_targets, validate_events)
from repro_torch.core import (Schedule, ScheduleCache, SipKernel,  # noqa: E402
                              TuneConfig, registry, schedule_cache)
from repro_torch.core.energy import (UnassemblableSchedule,  # noqa: E402
                                     device_seconds)
from repro_torch.core.testing import InputSpec, probabilistic_test  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._emit import random_legal_order  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.gemm_fused import kernel as gf  # noqa: E402
from repro_torch.kernels.gemm_fused import ops as gf_ops  # noqa: E402
from repro_torch.kernels.gemm_fused import ref as gf_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pg_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rk_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rk_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd import ops as sk_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as sk_ref  # noqa: E402
from repro_torch.launch import obsreport as obsreport_cli  # noqa: E402
from repro_torch.launch import tune as tune_cli  # noqa: E402
from repro_torch.launch import verify as verify_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      ServeConfig)

#: the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: (rtol, atol) of a kernel against its plain version: fp32 to 1e-4 (sums
#: in another order), bf16 to the repo's oracle tolerance
#: (TuneConfig.rtol/atol = 2e-2, repro/core/jit.py:43-44)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
#: the random legal orders each kernel phase runs beside the default
ORDER_SEEDS = (1, 2, 3, 4)
BF16, F32 = torch.bfloat16, torch.float32
#: every kernel module; each counts its launches
KERNEL_MODULES = (gf, fa, pg, sk, rk)


#: the live service's search per key: the JAX package's per-cycle round
#: (one short guided anneal on the cost model), its best checked on the card
#: by the final test and the gate's sweep instead of a step test per
#: candidate, so that a cycle builds about one text per key
LIVE_TUNE = dataclasses.replace(AutotuneConfig().tune, step_samples=0)

T0 = time.perf_counter()


def reset_launches() -> None:
    """Every kernel's launch counts to 0 (flash's by dtype too)."""
    for mod in KERNEL_MODULES:
        mod.launches = 0
    fa.dtype_launches.update(dict.fromkeys(fa.dtype_launches, 0))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    timed as the wall-clock energy times a schedule."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return device_seconds(fn, calls=iters) * 1e3


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


def compare(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    """Max abs error of ``got``; raises unless every element is within the
    dtype's (rtol, atol) of ``want``."""
    torch.cuda.synchronize()
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.shape != want.shape or not torch.isfinite(g).all() \
            or bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{what}: differs from its plain version "
                             f"(max abs err {err.max().item()})")
    return err.max().item()


def _randn(shape, dtype, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ------------------------------------------------------- kernel schedules
def gemm_kernel(m, n, k, dtype, order=None):
    return registry.spec(gf_ops.NAME).build(Schedule(order=order), m=m, n=n,
                                            k=k, dtype=_dt(dtype))


def flash_static(b, hq, hkv, sq, skv, d, causal, window, dtype) -> dict:
    return dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, causal=causal,
                window=window, dtype=_dt(dtype))


def flash_kernel(static, order=None):
    return fa_ops.build(Schedule(order=order), **static)


def gather_static(p, ps, h, d, b, n, dtype) -> dict:
    return dict(p=p, ps=ps, h=h, d=d, b=b, n=n, dtype=_dt(dtype))


def gather_kernel(static, knobs=None, order=None):
    return registry.spec(pg_ops.NAME).build(
        Schedule(knobs=knobs or {}, order=order), **static)


def ssd_static(g, q, h, p, n, dtype=F32) -> dict:
    return dict(g=g, q=q, h=h, p=p, n=n, dtype=_dt(dtype))


def ssd_kernel(static, order=None):
    return registry.spec(sk_ops.NAME).build(Schedule(order=order), **static)


def rms_static(rows, d, dtype) -> dict:
    return dict(rows=rows, d=d, dtype=_dt(dtype))


def rms_kernel(static, knobs=None, order=None):
    return registry.spec(rk_ops.NAME).build(
        Schedule(knobs=knobs or {}, order=order), **static)


def rms_knob_points(static) -> list[dict]:
    """Every point of the reference's knob space at ``static``."""
    sp = rk_ops.space(**static)
    return [dict(zip([k.name for k in sp.knobs], point))
            for point in itertools.product(*[k.choices for k in sp.knobs])]


def with_orders(make, seeds=ORDER_SEEDS):
    """The default schedule of ``make(order)`` and one per seed."""
    base = make(None)
    return [(None, base)] + [
        (s, make(random_legal_order(base.program, s))) for s in seeds]


def gemm_hoisted(prog, steps: int) -> tuple[int, ...]:
    """The order that issues step s+1's loads (ld_x, ld_w) above dot{s}:
    one k step in flight during each product (instructions: init_acc, then
    ld_x{s}, ld_w{s}, dot{s} per step, then the epilogue)."""
    order = [0, 1, 2]
    for s in range(steps):
        if s + 1 < steps:
            order += [1 + 3 * (s + 1), 2 + 3 * (s + 1)]
        order.append(3 + 3 * s)
    order += [i for i in prog.default_order() if i not in order]
    return tuple(order)


def flash_v_hoisted(prog) -> tuple[int, ...]:
    """The order that issues each ld_v{c} right after ld_k{c}: V's copy in
    flight through Q K^T and the softmax."""
    names = [ins.name for ins in prog.instrs]
    order = [i for i in prog.default_order()
             if not names[i].startswith("ld_v")]
    for c in range(sum(n.startswith("ld_v") for n in names)):
        order.insert(order.index(names.index(f"ld_k{c}")) + 1,
                     names.index(f"ld_v{c}"))
    return tuple(order)


def gemm_tiles(bm, bn, bk, dtype, hoist=False, m=512, n=512, k=2048):
    """The paper-shape gemm at a knob point, default or hoisted order."""
    kern = gf.GemmKernel(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype)
    if not hoist:
        return kern
    return gf.GemmKernel(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype,
                         order=gemm_hoisted(kern.program, k // bk))


def gemm_split(kern) -> dict[str, str]:
    """Two measuring copies of a gemm schedule's text: its copies alone
    (every dot{s} disabled) and its products alone (every load disabled,
    the products run on whatever shared memory holds).  They time where a
    step's time goes; their outputs are not used."""
    text = kern.source()[0]
    return {"loads_only": text.replace("dot_tile(X", "if (0) dot_tile(X"),
            "products_only": text.replace("load_x(x,", "if (0) load_x(x,")
            .replace("load_w(w,", "if (0) load_w(w,")}


def split_ms(kern, text: str, x, w) -> float:
    """Device time of one measuring copy of ``kern`` (see gemm_split),
    launched directly: not counted in ``gf.launches``."""
    smem = kern.source()[1]
    built = _build.load(gf.FUNCTION, text, smem)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    args = [ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(x.shape[0]),
            ctypes.c_int(w.shape[1])]
    return cuda_ms(lambda: built.launch(
        (x.shape[0] // kern.bm, w.shape[1] // kern.bn, 1),
        kern.layout["NT"], args))


def ssd_split(kern) -> dict[str, str]:
    """Three measuring copies of an SSD schedule's text, each with one part
    of a step disabled: its copies (the products and the decay run on
    whatever shared memory holds), its two products, or its decay and
    mask.  They time where a step's time goes; their outputs are not
    used."""
    text = kern.source()[0]
    return {"no_copies": text.replace("load_rows(cp,", "if (0) load_rows(cp,")
            .replace("load_rows(bp,", "if (0) load_rows(bp,")
            .replace("load_la(lp,", "if (0) load_la(lp,")
            .replace("load_x(xp,", "if (0) load_x(xp,"),
            "no_products": text.replace("\ncb_tile(", "\nif (0) cb_tile(")
            .replace("\ny_tile(", "\nif (0) y_tile("),
            "no_decay": text.replace("\ndecay_tile(", "\nif (0) decay_tile(")
            .replace("\nmul_tile(", "\nif (0) mul_tile(")}


def ssd_split_ms(kern, text: str, args) -> float:
    """Device time of one measuring copy of ``kern`` (see ssd_split),
    launched directly: not counted in ``sk.launches``."""
    built = _build.load(sk.FUNCTION, text, kern.source()[1])
    xb = args[0]
    g, q, h, _ = xb.shape
    out = torch.empty_like(xb)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, out)]
    return cuda_ms(lambda: built.launch(kern.grid(g, q, h, kern.br), sk.NT,
                                        ptrs + [ctypes.c_int(h)]))


GEMM_SHAPES = [(16, 16, 32), (64, 64, 128), (128, 128, 256), (512, 512, 2048)]
#: knob points of the paper's shape timed at the default and the hoisted
#: order, bf16
GEMM_TILES = [(64, 64, 64), (128, 128, 64), (128, 128, 128), (128, 256, 64)]
#: (m, n, k, bm, bn, bk): tiles smaller than the instruction, zero-filled in
#: shared memory, and one whose accumulator no block can hold
GEMM_PADDED = (64, 64, 128, 8, 8, 8)
GEMM_REJECTED = (512, 512, 2048, 512, 512, 64)
#: (b, hq, hkv, s_q, s_kv, d, causal, window); the first three run at the
#: random orders too: the smoke and deploy workloads and a serve prefill
FLASH_CASES = [(1, 2, 2, 16, 16, 8, True, None),
               (1, 4, 2, 128, 128, 32, True, None),
               (4, 16, 8, 128, 128, 128, True, None)] + [
    (2, 16, 8, s, s, 128, True, None) for s in (16, 37, 384, 500)] + [
    (2, 16, 8, 100, 100, 128, False, None),
    (2, 16, 8, 300, 300, 128, True, 64),
    (2, 16, 8, 37, 100, 128, True, None),
    (8, 16, 8, 100, 100, 128, True, None),
    (3, 16, 8, 45, 45, 32, True, None),
    (1, 16, 8, 70, 70, 64, True, None),
    (1, 32, 32, 128, 128, 112, True, None),     # zamba2's shared block
    (1, 32, 8, 300, 300, 80, True, 64)]         # h2o-danube's, windowed
#: (p, ps, h, d, b, n): smoke, deploy and the serve phase's store and table
GATHER_SHAPES = [(8, 8, 2, 8, 2, 4), (64, 16, 4, 32, 8, 8),
                 (257, 16, 8, 128, 8, 32)]
#: (g, q, h, p, n), float32 as on the model's path: the smoke and deploy
#: workloads, a 384-token prompt padded to chunks of 64, the serve
#: prefill's 256-token chunk, two such chunks, a head count that the
#: kernel's head groups do not divide, and zamba2's 256-token chunk and
#: padded 384-token prompt (112 heads, state 64)
SSD_SHAPES = [(2, 8, 2, 4, 8), (4, 16, 4, 8, 16), (6, 64, 80, 64, 128),
              (1, 256, 80, 64, 128), (2, 256, 80, 64, 128),
              (2, 128, 3, 64, 128), (1, 256, 112, 64, 64),
              (6, 64, 112, 64, 64)]
#: (rows, d): the smoke and deploy workloads and the model's width
RMS_SHAPES = [(16, 32), (64, 128), (4096, 2560)]


def gather_tiled(static) -> dict:
    """The finest tiling of the reference's knob space: the most tiles, so
    the most orders."""
    sp = pg_ops.space(**static)
    return {k.name: max(k.choices) for k in sp.knobs}


def all_schedules():
    """Every (function name, kernel) the kernel phases run."""
    for (m, n, k), dt in itertools.product(GEMM_SHAPES, (F32, BF16)):
        for _, kern in with_orders(lambda o: gemm_kernel(m, n, k, dt, o)):
            yield gf.FUNCTION, kern
    for tiles, hoist in itertools.product(GEMM_TILES, (False, True)):
        yield gf.FUNCTION, gemm_tiles(*tiles, BF16, hoist)
    m, n, k, bm, bn, bk = GEMM_PADDED
    for dt in (F32, BF16):
        yield gf.FUNCTION, gemm_tiles(bm, bn, bk, dt, m=m, n=n, k=k)
    for dt in (F32, BF16):
        st = flash_static(*FLASH_CASES[2], dt)
        yield fa.FUNCTION, flash_kernel(st, flash_v_hoisted(
            flash_kernel(st).program))
    for i, case in enumerate(FLASH_CASES):
        for dt in (F32, BF16):
            st = flash_static(*case, dt)
            seeds = ORDER_SEEDS if i < 3 else ()
            for _, kern in with_orders(lambda o: flash_kernel(st, o), seeds):
                yield fa.FUNCTION, kern
    for shape, dt in itertools.product(GATHER_SHAPES, (F32, BF16)):
        st = gather_static(*shape, dt)
        yield pg.FUNCTION, gather_kernel(st)
        for _, kern in with_orders(
                lambda o: gather_kernel(st, gather_tiled(st), o)):
            yield pg.FUNCTION, kern
    for shape in SSD_SHAPES:
        st = ssd_static(*shape)
        for _, kern in with_orders(lambda o: ssd_kernel(st, o)):
            yield sk.FUNCTION, kern
    for shape, dt in itertools.product(RMS_SHAPES, (F32, BF16)):
        st = rms_static(*shape, dt)
        for _, kern in with_orders(lambda o: rms_kernel(st, None, o)):
            yield rk.FUNCTION, kern
        if shape == RMS_SHAPES[-1]:
            for knobs in rms_knob_points(st):
                yield rk.FUNCTION, rms_kernel(st, knobs)


# ------------------------------------------------------------------ phases
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


def phase_build() -> dict:
    """Emit every schedule the kernel phases run and compile them all in
    parallel, one nvcc per text."""
    t0 = time.perf_counter()
    texts, rejected = [], 0
    _build.STATS.reset()
    for fn, kern in all_schedules():
        try:
            texts.append((fn, kern.source()[0]))
        except UnassemblableSchedule:
            rejected += 1
    texts += [(gf.FUNCTION, text) for text in gemm_split(
        gemm_kernel(512, 512, 2048, BF16)).values()]
    texts += [(sk.FUNCTION, text) for shape in (SSD_SHAPES[3], SSD_SHAPES[2])
              for text in ssd_split(ssd_kernel(ssd_static(*shape))).values()]
    emit_s = time.perf_counter() - t0
    rejections = {k: getattr(_build.STATS, k)
                  for k in ("smem_rejections", "reg_rejections")}
    _build.STATS.reset()
    t0 = time.perf_counter()
    _build.compile_many(texts)
    wall = time.perf_counter() - t0
    main = {"gemm_fused 512x512x2048 bf16":
            (gf.FUNCTION, gemm_kernel(512, 512, 2048, BF16)),
            "flash_attention b4 s128 d128 bf16":
            (fa.FUNCTION, flash_kernel(flash_static(*FLASH_CASES[2], BF16))),
            "flash_attention b4 s128 d128 f32":
            (fa.FUNCTION, flash_kernel(flash_static(*FLASH_CASES[2], F32))),
            "paged_gather serve bf16":
            (pg.FUNCTION, gather_kernel(gather_static(*GATHER_SHAPES[2],
                                                      BF16))),
            "ssd_intra_chunk g1 q256 h80 f32":
            (sk.FUNCTION, ssd_kernel(ssd_static(*SSD_SHAPES[3]))),
            "rmsnorm_fused 4096x2560 bf16":
            (rk.FUNCTION, rms_kernel(rms_static(*RMS_SHAPES[-1], BF16)))}
    ptxas = {label: [ln.strip() for ln in _build.build_log(
        fn, kern.source()[0]).splitlines() if "registers" in ln or "spill" in ln]
        for label, (fn, kern) in main.items()}
    # distinct texts whose registers spilled to local memory, by function:
    # check_regs rejects only what no SM's register file can hold
    spilled: dict[str, int] = {}
    for fn, text in set(texts):
        log = _build.build_log(fn, text)
        if "spill stores" in log and " 0 bytes spill stores" not in log:
            spilled[fn] = spilled.get(fn, 0) + 1
    # the designs are really compiled: wgmma is HGMMA in the SASS, mma.sync
    # HMMA (the f32 flash's 3xTF32 too; its FFMA are the softmax's exp),
    # the SSD's fp64 mma.sync DMMA (its decay's fp64 exp keeps some DFMA),
    # RMSNorm's 16-byte loads LDG.E.128
    in_sass = {}
    for label, (fn, kern), want in (
            ("gemm_fused 512x512x2048 bf16",
             main["gemm_fused 512x512x2048 bf16"], "HGMMA"),
            ("gemm_fused 512x512x2048 f32",
             (gf.FUNCTION, gemm_kernel(512, 512, 2048, F32)), "HMMA"),
            ("flash_attention b4 s128 d128 bf16",
             main["flash_attention b4 s128 d128 bf16"], "HMMA"),
            ("flash_attention b4 s128 d128 f32",
             main["flash_attention b4 s128 d128 f32"], "HMMA"),
            ("ssd_intra_chunk g1 q256 h80 f32",
             main["ssd_intra_chunk g1 q256 h80 f32"], "DMMA"),
            ("rmsnorm_fused 4096x2560 bf16",
             main["rmsnorm_fused 4096x2560 bf16"], "LDG.E.128")):
        sass = _sass(_build.cubin_path(fn, kern.source()[0])).splitlines()
        count = sum(want in ln for ln in sass)
        if not count:
            raise AssertionError(f"{label}: no {want} instruction in its SASS")
        in_sass[label] = {"instruction": want, "count": count}
        if fn == sk.FUNCTION:
            in_sass[label]["DFMA"] = sum("DFMA" in ln for ln in sass)
        if fn == fa.FUNCTION:
            in_sass[label]["FFMA"] = sum("FFMA" in ln for ln in sass)
        if fn == rk.FUNCTION:
            in_sass[label]["STG.E.128"] = sum("STG.E.128" in ln
                                                   for ln in sass)
    out = {"texts": len(texts), "distinct_texts": len(set(texts)),
           "smem_rejected": rejected, "emit_s": emit_s, "wall_s": wall,
           **_build.STATS.snapshot(), **rejections,
           "ptxas_main_shapes": ptxas, "texts_that_spill": spilled,
           "designs_in_sass": in_sass}
    emit("build", **out)
    return out


def _run_orders(label, make, args, plain, dtype, seeds=ORDER_SEEDS,
                time_it=False) -> dict:
    want = plain(*args)
    rows, worst = [], 0.0
    for seed, kern in with_orders(make, seeds):
        row = {"order_seed": seed}
        try:
            got = kern(*args)
        except UnassemblableSchedule as e:
            rows.append({**row, "rejected": str(e)[:120]})
            continue
        row["max_abs_err"] = compare(got, want, dtype, f"{label} seed {seed}")
        worst = max(worst, row["max_abs_err"])
        if time_it:
            row["ms"] = cuda_ms(lambda: kern(*args))
        rows.append(row)
    return {"case": label, "dtype": _dt(dtype), "orders": rows,
            "max_abs_err": worst}


def phase_gemm(gen) -> dict:
    results = []
    for (m, n, k), dt in itertools.product(GEMM_SHAPES, (F32, BF16)):
        x, w = _randn((m, k), dt, gen), _randn((k, n), dt, gen)
        results.append(_run_orders(
            f"gemm {m}x{n}x{k}", lambda o: gemm_kernel(m, n, k, dt, o),
            (x, w), gf_ref.gemm_leaky_relu, dt,
            time_it=(m, n, k) == (512, 512, 2048)))
    timed = {}
    for dt in (BF16, F32):      # the paper's shape (benchmarks/table3_gemm.py)
        m = n = 512
        k = 2048
        x, w = _randn((m, k), dt, gen), _randn((k, n), dt, gen)
        kern = gemm_kernel(m, n, k, dt)
        esize = x.element_size()
        t_ops = 2 * m * n * k / PEAK_FLOPS[dt]
        t_bytes = (m * k + k * n + m * n) * esize / PEAK_BYTES
        split = {f"{key}_ms": split_ms(kern, text, x, w)
                 for key, text in gemm_split(kern).items()} \
            if dt == BF16 else {}
        timed[_dt(dt)] = {
            **split,
            "ms": cuda_ms(lambda: kern(x, w)),
            "plain_ms": cuda_ms(lambda: gf_ref.gemm_leaky_relu(x, w)),
            "library_ms": cuda_ms(lambda: torch.nn.functional.leaky_relu(
                x @ w, 0.01)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    # the pipeline depth the order sets: each knob point at the default
    # order (no copy in flight during a product) and with step s+1's loads
    # above dot{s}, timed in turns (default, hoisted, hoisted, default)
    x, w = _randn((512, 2048), BF16, gen), _randn((2048, 512), BF16, gen)
    want = gf_ref.gemm_leaky_relu(x, w)
    tiles = {}
    for bm, bn, bk in GEMM_TILES:
        pair = {"default": gemm_tiles(bm, bn, bk, BF16),
                "hoisted": gemm_tiles(bm, bn, bk, BF16, hoist=True)}
        row = {f"{key}_smem": kern.source()[1] for key, kern in pair.items()}
        for key, kern in pair.items():
            row[f"{key}_max_abs_err"] = compare(
                kern(x, w), want, BF16, f"gemm tiles {(bm, bn, bk)} {key}")
        times = {"default": [], "hoisted": []}
        for key in ("default", "hoisted", "hoisted", "default"):
            times[key].append(cuda_ms(lambda: pair[key](x, w)))
        row.update({f"{key}_ms": float(np.mean(t)) for key, t in times.items()})
        tiles[f"{bm}x{bn}x{bk}"] = row
    # tiles smaller than the instruction, zero-filled in shared memory; a
    # tile whose accumulator no block can hold is rejected before any build
    m, n, k, bm, bn, bk = GEMM_PADDED
    padded = {}
    for dt in (F32, BF16):
        x, w = _randn((m, k), dt, gen), _randn((k, n), dt, gen)
        padded[_dt(dt)] = compare(
            gemm_tiles(bm, bn, bk, dt, m=m, n=n, k=k)(x, w),
            gf_ref.gemm_leaky_relu(x, w), dt, f"gemm padded {GEMM_PADDED}")
    m, n, k, bm, bn, bk = GEMM_REJECTED
    try:
        gemm_tiles(bm, bn, bk, BF16, m=m, n=n, k=k).source()
    except UnassemblableSchedule as e:
        rejected = str(e)
    else:
        raise AssertionError(f"gemm {GEMM_REJECTED}: assembled; its "
                             f"accumulator cannot fit a block's registers")
    worst = max(r["max_abs_err"] for r in results if r["dtype"] == "bfloat16")
    out = {"cases": results, "timed_512x512x2048": timed,
           "tiles_512x512x2048_bf16": tiles,
           "padded_tiles_max_abs_err": padded, "rejected_tile": rejected,
           "max_abs_err_bf16": worst,
           "max_abs_err_f32": max(r["max_abs_err"] for r in results
                                  if r["dtype"] == "float32")}
    emit("gemm_fused", **out)
    return {**out, **timed["bfloat16"], "max_abs_err": worst}


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
    results, worst = [], {F32: 0.0, BF16: 0.0}
    for i, case in enumerate(FLASH_CASES):
        b, hq, hkv, sq, skv, d, causal, window = case
        for dt in (F32, BF16):
            q = _randn((b, hq, sq, d), dt, gen)
            k = _randn((b, hkv, skv, d), dt, gen)
            v = _randn((b, hkv, skv, d), dt, gen)
            st = flash_static(*case, dt)
            res = _run_orders(
                f"flash {case}", lambda o: flash_kernel(st, o), (q, k, v),
                lambda q, k, v: fa_ref.attention(q, k, v, causal=causal,
                                                 window=window), dt,
                seeds=ORDER_SEEDS if i < 3 else (), time_it=i == 2)
            worst[dt] = max(worst[dt], res["max_abs_err"])
            results.append(res)
    timed = {}
    for b, s in ((4, 128), (4, 384)):   # a serve prefill and a longer one
        q = _randn((b, 16, s, 128), BF16, gen)
        k = _randn((b, 8, s, 128), BF16, gen)
        v = _randn((b, 8, s, 128), BF16, gen)
        # the library yardstick takes repeated kv heads, made outside the
        # timed region
        kr, vr = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
        bound_ms, bound_by = attention_bound_ms(b, 16, 8, s, s, 128, 2, True,
                                                None, PEAK_FLOPS[BF16])
        timed[f"b{b}_s{s}"] = {
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "plain_ms": cuda_ms(lambda: fa_ref.attention(q, k, v,
                                                         causal=True)),
            "library_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "registry_call_host_us": host_us(
                lambda: fa.flash_attention(q, k, v, causal=True))}
    timed["b4_s128_orders"] = flash_orders(BF16, gen)
    # a serve prefill at a length that is not a multiple of 8: the model's
    # call pads it to 128 rows; the schedule at the exact length has 1-row
    # query tiles
    b, s = 8, 100
    q = _randn((b, 16, s, 128), BF16, gen)
    k = _randn((b, 8, s, 128), BF16, gen)
    v = _randn((b, 8, s, 128), BF16, gen)
    exact = flash_kernel(flash_static(b, 16, 8, s, s, 128, True, None, BF16))
    padded = fa.flash_attention(q, k, v, causal=True)
    compare(padded, fa_ref.attention(q, k, v, causal=True), BF16,
            "flash padded b8 s100")
    kr, vr = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    bound_ms, bound_by = attention_bound_ms(b, 16, 8, s, s, 128, 2, True,
                                            None, PEAK_FLOPS[BF16])
    timed["b8_s100"] = {
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "exact_length_ms": cuda_ms(lambda: exact(q, k, v)),
        "exact_length_tiles": [exact.bq, exact.bk],
        "padded_length": -(-s // fa.SEQ_TILE) * fa.SEQ_TILE,
        "plain_ms": cuda_ms(lambda: fa_ref.attention(q, k, v, causal=True)),
        "library_ms": cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kr, vr, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by}
    # a bidirectional call at an odd length is padded too, the padded keys
    # masked past its real length (unpadded, 501 f32 keys give one 1 x 501
    # tile)
    bidir = {}
    for dt in (F32, BF16):
        q = _randn((2, 16, 501, 128), dt, gen)
        k = _randn((2, 8, 501, 128), dt, gen)
        v = _randn((2, 8, 501, 128), dt, gen)
        bidir[_dt(dt)] = compare(
            fa.flash_attention(q, k, v, causal=False),
            fa_ref.attention(q, k, v, causal=False), dt,
            f"flash bidirectional s501 {dt}")
    timed["bidirectional_s501_max_abs_err"] = bidir
    if timed["b8_s100"]["ms"] >= timed["b8_s100"]["exact_length_ms"]:
        raise AssertionError(f"flash at b8 s100: the padded call is no "
                             f"faster than 1-row tiles: {timed['b8_s100']}")
    timed_f32 = flash_timed_f32(gen)
    out = {"cases": results, "max_abs_err_f32": worst[F32],
           "max_abs_err_bf16": worst[BF16], "timed_bf16_causal": timed,
           "timed_f32_causal": timed_f32,
           "timed_bf16_serve_shapes": flash_serve_shapes(gen)}
    emit("flash_attention", **out)
    return {**out, **timed["b4_s128"], "max_abs_err": worst[BF16],
            "f32": {**timed_f32["b4_s128"], "max_abs_err": worst[F32]}}


def flash_orders(dtype, gen) -> dict:
    """The default order against one that issues each ld_v{c} after its
    ld_k{c}, at B4 S128 D128, in turns (default, hoisted, hoisted,
    default)."""
    st = flash_static(*FLASH_CASES[2], dtype)
    pair = {"default": flash_kernel(st)}
    pair["v_hoisted"] = flash_kernel(st, flash_v_hoisted(
        pair["default"].program))
    q = _randn((4, 16, 128, 128), dtype, gen)
    k = _randn((4, 8, 128, 128), dtype, gen)
    v = _randn((4, 8, 128, 128), dtype, gen)
    want = fa_ref.attention(q, k, v, causal=True)
    orders = {}
    for key, kern in pair.items():
        orders[f"{key}_max_abs_err"] = compare(kern(q, k, v), want, dtype,
                                               f"flash b4 s128 {key}")
        orders[f"{key}_smem"] = kern.source()[1]
    times = {"default": [], "v_hoisted": []}
    for key in ("default", "v_hoisted", "v_hoisted", "default"):
        times[key].append(cuda_ms(lambda: pair[key](q, k, v)))
    orders.update({f"{key}_ms": float(np.mean(t)) for key, t in times.items()})
    return orders


#: bf16 flash at the new serve paths' prefill shapes: label -> (b, hq, hkv,
#: s, d, window); zamba2's 384-token prompt (MHA, D 112), h2o-danube's
#: 4,500-token prompt padded to 4,544 (GQA 4:1, D 80, window 4096), and
#: dbrx's and llava's longest whole-prompt prefill on the paged engine
#: (the 128-token chunk; GQA 6:1 and 7:1, D 128)
FLASH_SERVE_SHAPES = {"zamba2_b1_s384_d112": (1, 32, 32, 384, 112, None),
                      "danube_b1_s4544_d80_w4096": (1, 32, 8, 4544, 80,
                                                    4096),
                      "dbrx_b1_s128_gqa48_8": (1, 48, 8, 128, 128, None),
                      "llava_b1_s128_gqa56_8": (1, 56, 8, 128, 128, None)}


#: the limit on a serve-shape flash call's largest per-row relative error
#: ||got - want|| / ||want|| over the head dim.  Over 4,096 keys of
#: unit-normal logits a typical output element is about 0.02, as small as
#: the fixed atol of ``TOL``, so that check alone misses a dropped tile;
#: bf16 rounds P and the output at 2**-8 each, a few 1e-3 of a row
ROW_RTOL = 1e-2


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of ||got - want|| / ||want|| along the last axis."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()


def _zero_last_tile(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, H, S, D) with its last ``fa.SEQ_TILE`` keys zeroed."""
    x = x.clone()
    x[:, :, -fa.SEQ_TILE:] = 0
    return x


def flash_serve_shapes(gen) -> dict:
    """bf16 flash through the model's entry point at the hybrid's and the
    sliding-window model's serve prefills, against its plain version, the
    bound for the work inside the masks, and SDPA (kv heads repeated and a
    window's boolean mask made outside the timed region).  Besides
    ``compare``, each row's relative error must be within ``ROW_RTOL``,
    and two wrong calls must fail that check: the last key tile zeroed,
    and (windowed) no window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for label, (b, hq, hkv, s, d, window) in FLASH_SERVE_SHAPES.items():
        q = _randn((b, hq, s, d), BF16, gen)
        k = _randn((b, hkv, s, d), BF16, gen)
        v = _randn((b, hkv, s, d), BF16, gen)
        kr = k.repeat_interleave(hq // hkv, dim=1)
        vr = v.repeat_interleave(hq // hkv, dim=1)

        def kern():
            return fa.flash_attention(q, k, v, causal=True, window=window)

        def plain():
            return fa_ref.attention(q, k, v, causal=True, window=window)

        if window is None:
            def library():
                return sdpa(q, kr, vr, is_causal=True)
        else:
            rows = torch.arange(s, device="cuda")[:, None]
            cols = torch.arange(s, device="cuda")[None, :]
            mask = (cols <= rows) & (cols > rows - window)

            def library():
                return sdpa(q, kr, vr, attn_mask=mask)
        before = fa.launches
        got, want = kern(), plain()
        if fa.launches != before + 1:
            raise AssertionError(f"flash {label}: the kernel did not launch")
        err = compare(got, want, BF16, f"flash {label}")
        rel = row_rel_err(got, want)
        # what a wrong kernel gives must fail the same check
        controls = {"last_kv_tile_zeroed": row_rel_err(fa.flash_attention(
            q, _zero_last_tile(k), _zero_last_tile(v), causal=True,
            window=window), want)}
        if window is not None:
            controls["no_window"] = row_rel_err(fa.flash_attention(
                q, k, v, causal=True, window=None), want)
        del got
        if rel > ROW_RTOL or min(controls.values()) <= ROW_RTOL:
            raise AssertionError(f"flash {label}: row error {rel} against "
                                 f"{ROW_RTOL}, controls {controls}")
        bound_ms, bound_by = attention_bound_ms(b, hq, hkv, s, s, d, 2, True,
                                                window, PEAK_FLOPS[BF16])
        timed[label] = {
            "shape": [b, hq, hkv, s, d], "window": window,
            "max_abs_err": err, "max_abs_want": want.abs().max().item(),
            "row_rel_err": rel, "row_rtol": ROW_RTOL,
            "controls_row_rel_err": controls, "ms": cuda_ms(kern, iters=20),
            "plain_ms": cuda_ms(plain, iters=5, warmup=1),
            "library_ms": cuda_ms(library, iters=20),
            "library_max_abs_err": (library().float()
                                    - want.float()).abs().max().item(),
            "bound_ms": bound_ms, "bound_by": bound_by}
    return timed


#: float32 flash timed at a serve prefill, a longer one and the registry's
#: deploy workload: label -> (b, hq, hkv, s, d), causal
FLASH_F32_TIMED = {"b4_s128": (4, 16, 8, 128, 128),
                   "b4_s384": (4, 16, 8, 384, 128),
                   "deploy_b1_s128_d32": (1, 4, 2, 128, 32)}


def flash_timed_f32(gen) -> dict:
    """The float32 kernel at its default schedule through the model's entry
    point, beside its plain version and f32 SDPA on its efficient backend
    (3xTF32 on the tensor cores, the yardstick; kv heads repeated outside
    the timed region), and the paired ld_v-hoisted order at B4 S128."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for label, (b, hq, hkv, s, d) in FLASH_F32_TIMED.items():
        q = _randn((b, hq, s, d), F32, gen)
        k = _randn((b, hkv, s, d), F32, gen)
        v = _randn((b, hkv, s, d), F32, gen)
        kr = k.repeat_interleave(hq // hkv, dim=1)
        vr = v.repeat_interleave(hq // hkv, dim=1)
        want = fa_ref.attention(q, k, v, causal=True)
        err = compare(fa.flash_attention(q, k, v, causal=True), want, F32,
                      f"flash f32 {label}")
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_err = (sdpa(q, kr, vr, is_causal=True) - want).abs().max()
            library_ms = cuda_ms(lambda: sdpa(q, kr, vr, is_causal=True))
        bound_ms, bound_by = attention_bound_ms(b, hq, hkv, s, s, d, 4, True,
                                                None, PEAK_FLOPS[F32])
        timed[label] = {
            "shape": [b, hq, hkv, s, d], "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "plain_ms": cuda_ms(lambda: fa_ref.attention(q, k, v,
                                                         causal=True)),
            "library_ms": library_ms,
            "library": "sdpa EFFICIENT_ATTENTION",
            "library_max_abs_err": lib_err.item(),
            "bound_ms": bound_ms, "bound_by": bound_by}
    timed["b4_s128_orders"] = flash_orders(F32, gen)
    return timed


def phase_gather(gen) -> dict:
    results = []
    for shape, dt in itertools.product(GATHER_SHAPES, (F32, BF16)):
        p, ps, h, d, b, n = shape
        store = _randn((p, ps, h, d), dt, gen)
        pt = torch.randint(-p, p, (b, n), generator=gen, device="cuda",
                           dtype=torch.int32)
        pt[0, 0], pt[0, 1], pt[-1, -1] = -1, -p, 0      # wrap to p-1 and 0
        st = gather_static(*shape, dt)
        want = pg_ref.paged_gather(store, pt)
        for knobs in ({}, gather_tiled(st)):
            for seed, kern in with_orders(
                    lambda o: gather_kernel(st, knobs, o),
                    ORDER_SEEDS if knobs else ()):
                if not torch.equal(kern(store, pt), want):
                    raise AssertionError(f"paged_gather {shape} {dt} "
                                         f"{knobs} seed {seed}: differs "
                                         f"from store[page_table]")
                results.append({"shape": list(shape), "dtype": _dt(dt),
                                "knobs": knobs, "order_seed": seed,
                                "bitwise_equal": True})
    # the serve phase's exact shapes, bf16
    store = _randn((257, 16, 8, 128), BF16, gen)
    pt = torch.randint(0, 257, (8, 32), generator=gen, device="cuda",
                       dtype=torch.int32)
    pt[0, 0] = 0                    # the trash page
    pt[3, :4] = pt[2, :4]           # pages shared between slots
    flat = pt.reshape(-1)
    # the decode step gathers each layer's store after other work, so time
    # with cold L2: 8 stores (67 MB in all) taken in turn
    stores = _randn((8,) + tuple(store.shape), BF16, gen)
    turn = itertools.count()

    def cold() -> torch.Tensor:
        return stores[next(turn) % len(stores)]

    direct = gather_kernel(gather_static(257, 16, 8, 128, 8, 32, BF16))
    nbytes = pt.numel() * store[0].numel() * store.element_size()
    out = {"cases": results, "negative_ids_bitwise_equal": True,
           "store": list(store.shape), "table": list(pt.shape),
           "max_abs_err": 0.0, "l2": "cold",
           "ms": cuda_ms(lambda: pg.paged_gather(cold(), pt)),
           "plain_ms": cuda_ms(lambda: pg_ref.paged_gather(cold(), pt)),
           "library_ms": cuda_ms(lambda: torch.index_select(cold(), 0, flat)),
           "bound_ms": 2 * nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "registry_call_host_us": host_us(lambda: pg.paged_gather(store,
                                                                    pt)),
           "kernel_call_host_us": host_us(lambda: direct(store, pt))}
    emit("paged_gather", **out)
    return out


def ssd_inputs(g, q, h, p, n, gen, decaying: bool = True):
    """(xb, la, B, C) as the model passes them: float32, la = dt * A < 0
    (``decaying``), or standard-normal la as the SIP tests draw it."""
    la = _randn((g, q, h), F32, gen)
    la = -la.abs() * 0.1 if decaying else la
    return (_randn((g, q, h, p), F32, gen), la,
            _randn((g, q, n), F32, gen) * 0.3,
            _randn((g, q, n), F32, gen) * 0.3)


def ssd_bound_ms(g, q, h, p, n) -> tuple[float, str]:
    """The least time for the function: the work at and below the diagonal
    (the rest of W is zero), C B^T once per chunk (every head shares it),
    W x per head, and the decay's difference, exp and the mask's product per
    entry, in fp32 at 67 TFLOP/s; against xb, la, B, C read and y written
    once at 3.35 TB/s."""
    tri = q * (q + 1) // 2
    flops = g * (2 * n * tri + h * (2 * p * tri + 3 * tri))
    nbytes = 4 * (2 * g * q * h * p + g * q * h + 2 * g * q * n)
    t_ops, t_bytes = flops / PEAK_FLOPS[F32], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_ssd(gen) -> dict:
    results = []
    for shape in SSD_SHAPES:
        st = ssd_static(*shape)
        results.append(_run_orders(
            f"ssd {shape}", lambda o: ssd_kernel(st, o),
            ssd_inputs(*shape, gen), sk_ref.intra_chunk, F32))
    # the SIP tests' draw: standard-normal la, so the decay reaches e^40 and
    # more over a 256-row chunk; held to the oracle's tolerance
    args = ssd_inputs(*SSD_SHAPES[3], gen, decaying=False)
    got, want = ssd_kernel(ssd_static(*SSD_SHAPES[3]))(*args), \
        sk_ref.intra_chunk(*args)
    if not (torch.isfinite(got).all() and torch.allclose(
            got, want, rtol=2e-2, atol=2e-2)):
        raise AssertionError("ssd at standard-normal la: not finite or not "
                             "within 2e-2 of its plain version")
    positive = {"max_abs_y": want.abs().max().item(),
                "max_rel_err": ((got - want).abs()
                                / want.abs().clamp_min(1.0)).max().item()}
    # the kernel first, then the plain version on the CPU: no buffer of the
    # plain version's can stand in for an output the kernel did not write
    args = ssd_inputs(*SSD_SHAPES[3], gen)
    got = ssd_kernel(ssd_static(*SSD_SHAPES[3]))(*args).cpu()
    want = sk_ref.intra_chunk(*[a.cpu() for a in args])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    vs_cpu = (got - want).abs().max().item()
    timed = {}
    for shape in (SSD_SHAPES[3], SSD_SHAPES[2], SSD_SHAPES[6],
                  SSD_SHAPES[7]):
        args = ssd_inputs(*shape, gen)
        normal = ssd_inputs(*shape, gen, decaying=False)
        kern = ssd_kernel(ssd_static(*shape))
        g, q, h = shape[:3]
        bound_ms, bound_by = ssd_bound_ms(*shape)
        timed["g{}_q{}_h{}_p{}_n{}".format(*shape)] = {
            "heads_per_block": kern.layout["HG"],
            "grid": list(kern.grid(g, q, h, kern.br)),
            "smem_bytes": kern.source()[1],
            "ms": cuda_ms(lambda: kern(*args)),
            "ms_standard_normal_la": cuda_ms(lambda: kern(*normal)),
            **{f"{key}_ms": ssd_split_ms(kern, text, args)
               for key, text in ssd_split(kern).items()},
            "plain_ms": cuda_ms(lambda: sk_ref.intra_chunk(*args)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    out = {"cases": results, "standard_normal_la_q256": positive,
           "max_abs_err_vs_cpu_plain_q256": vs_cpu,
           "max_abs_err": max(r["max_abs_err"] for r in results),
           "timed_f32": timed}
    emit("ssd_intra_chunk", **out)
    return {**out, **timed["g1_q256_h80_p64_n128"]}


def phase_rmsnorm(gen) -> dict:
    results, worst = [], {F32: 0.0, BF16: 0.0}
    for shape, dt in itertools.product(RMS_SHAPES, (F32, BF16)):
        st = rms_static(*shape, dt)
        args = (_randn(shape, dt, gen), _randn((shape[1],), dt, gen))
        res = _run_orders(f"rmsnorm {shape}", lambda o: rms_kernel(st, None, o),
                          args, rk_ref.rmsnorm, dt)
        if shape == RMS_SHAPES[-1]:
            want = rk_ref.rmsnorm(*args)
            res["knob_points"] = [
                {**knobs, "max_abs_err": compare(
                    rms_kernel(st, knobs)(*args), want, dt,
                    f"rmsnorm {shape} {knobs}")}
                for knobs in rms_knob_points(st)]
        worst[dt] = max([worst[dt], res["max_abs_err"]] + [
            k["max_abs_err"] for k in res.get("knob_points", [])])
        results.append(res)
    timed = {}
    rows, d = RMS_SHAPES[-1]
    for dt in (BF16, F32):
        x, g = _randn((rows, d), dt, gen), _randn((d,), dt, gen)
        kern = rms_kernel(rms_static(rows, d, dt))
        # x and y together (42 MB in bf16) fit the 50 MB L2, so the cold
        # times take 6 inputs (126 MB or more) in turn, as a model's norm
        # finds its input after other work
        xs = [_randn((rows, d), dt, gen) for _ in range(6)]
        turn = itertools.count()

        def cold() -> torch.Tensor:
            return xs[next(turn) % len(xs)]

        timed[_dt(dt)] = {
            "l2": "cold", "grid": kern.grid(rows), "block": kern.threads,
            "vec": kern.vec,
            "ms": cuda_ms(lambda: kern(cold(), g)),
            "plain_ms": cuda_ms(lambda: rk_ref.rmsnorm(cold(), g)),
            "library_ms": cuda_ms(lambda: torch.nn.functional.rms_norm(
                cold(), (d,), g, rk.EPS)),
            "ms_warm": cuda_ms(lambda: kern(x, g)),
            "plain_ms_warm": cuda_ms(lambda: rk_ref.rmsnorm(x, g)),
            "library_ms_warm": cuda_ms(lambda: torch.nn.functional.rms_norm(
                x, (d,), g, rk.EPS)),
            "bound_ms": (2 * rows * d + d) * x.element_size() / PEAK_BYTES
            * 1e3, "bound_by": "bytes",
            "knob_points_ms_cold": {
                f"br{k['br']}_nch{k['n_chunks']}": cuda_ms(
                    lambda kk=rms_kernel(rms_static(rows, d, dt), k): kk(
                        cold(), g), iters=20)
                for k in rms_knob_points(rms_static(rows, d, dt))}}
        del xs
    out = {"cases": results, "max_abs_err_f32": worst[F32],
           "max_abs_err_bf16": worst[BF16], "timed_4096x2560": timed}
    emit("rmsnorm_fused", **out)
    return {**out, **timed["bfloat16"], "max_abs_err": worst[BF16]}


def _sass(cubin: Path) -> str:
    """The cubin's SASS listing (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def _sass_hash(cubin: Path) -> str | None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    code = [ln.split("/*")[1] if ln.strip().startswith("/*") else ln
            for ln in _sass(cubin).splitlines() if ";" in ln]
    return hashlib.sha256("\n".join(code).encode()).hexdigest()


def distinct_cubins() -> dict:
    """Do 16 random legal orders of each kernel survive nvcc/ptxas as 16
    different binaries?"""
    makers = {
        "gemm_fused_leaky_relu 512x512x2048 bf16":
            lambda o: gemm_kernel(512, 512, 2048, BF16, o),
        "flash_attention_causal b4 s128 d128 bf16":
            lambda o: flash_kernel(flash_static(*FLASH_CASES[2], BF16), o),
        "paged_gather serve store, rows 8 n_chunks 4, bf16":
            lambda o: gather_kernel(
                gather_static(*GATHER_SHAPES[2], BF16),
                gather_tiled(gather_static(*GATHER_SHAPES[2], BF16)), o),
        "ssd_intra_chunk g1 q256 h80 p64 n128 f32":
            lambda o: ssd_kernel(ssd_static(*SSD_SHAPES[3]), o),
        "rmsnorm_fused 4096x2560 bf16, br 256 n_chunks 4":
            lambda o: rms_kernel(rms_static(*RMS_SHAPES[-1], BF16), None, o)}
    out = {}
    for label, make in makers.items():
        base = make(None)
        orders = {random_legal_order(base.program, s) for s in range(16)}
        texts, rejected = [], 0
        fn = {gf.GemmKernel: gf.FUNCTION, fa.FlashKernel: fa.FUNCTION,
              pg.GatherKernel: pg.FUNCTION, sk.SsdKernel: sk.FUNCTION,
              rk.RmsNormKernel: rk.FUNCTION}[type(base)]
        for order in orders:
            try:
                texts.append((fn, make(order).source()[0]))
            except UnassemblableSchedule:
                rejected += 1
        paths = _build.compile_many(texts)
        cubins = {hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}
        sass = {_sass_hash(p) for p in paths}
        out[label] = {"random_orders": 16, "distinct_orders": len(orders),
                      "smem_rejected": rejected,
                      "distinct_texts": len({t for _, t in texts}),
                      "distinct_cubins": len(cubins),
                      "distinct_sass": None if None in sass else len(sass)}
    return out


def phase_sip(workdir: Path) -> dict:
    """The SIP main path on the card: smoke tune, verify on its store, a
    wall-clock tune of each kernel at its main-path shape, and the
    distinct-cubin count."""
    cache = workdir / "sip_smoke.json"
    reset_launches()
    _build.STATS.reset()
    t0 = time.perf_counter()
    if tune_cli.main(["--smoke", "--cache", str(cache)]) != 0:
        raise AssertionError("tune --smoke failed on the card")
    tune_s = time.perf_counter() - t0
    smoke_builds = _build.STATS.snapshot()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify_cli.main(["--suite", "smoke", "--cache", str(cache)])
    print(buf.getvalue(), end="", flush=True)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[verify] ") and "workload(s)" not in ln]
    smoke = [w for spec in registry.specs() for w in spec.workloads_in("smoke")]
    if rc != 0 or len(lines) != len(smoke) or not all(
            ln.startswith("[verify] PASS") and "tuned schedule" in ln
            for ln in lines):
        raise AssertionError(f"verify on the card's smoke store: rc {rc}")

    # one wall-clock tune per kernel at its main-path shape: the paper's
    # gemm (benchmarks/table3_gemm.py), a serve prefill, the serve gather
    gen = torch.Generator(device="cuda").manual_seed(5)
    pt = torch.randint(0, 257, (8, 32), generator=gen, device="cuda",
                       dtype=torch.int32)
    wall_tunes = {
        "gemm_fused_leaky_relu 512x512x2048 bf16": (gf_ops.NAME, [
            _randn((512, 2048), BF16, gen), _randn((2048, 512), BF16, gen)]),
        "flash_attention_causal b4 s128 d128 bf16": (
            fa_ops.variant_name(True, None), [
                _randn((4, 16, 128, 128), BF16, gen),
                _randn((4, 8, 128, 128), BF16, gen),
                _randn((4, 8, 128, 128), BF16, gen)]),
        "paged_gather serve store bf16": (pg_ops.NAME, [
            _randn((257, 16, 8, 128), BF16, gen), pt]),
        "ssd_intra_chunk serve prefill g1 q256 h80 p64 n128 f32": (
            sk_ops.NAME, list(ssd_inputs(*SSD_SHAPES[3], gen))),
        "rmsnorm_fused 4096x2560 bf16": (rk_ops.NAME, [
            _randn(RMS_SHAPES[-1], BF16, gen),
            _randn((RMS_SHAPES[-1][1],), BF16, gen)])}
    wall_tune = {}
    for label, (name, args) in wall_tunes.items():
        _build.STATS.reset()
        kern = registry.spec(name).instantiate(cache=ScheduleCache())
        t0 = time.perf_counter()
        (res,) = kern.tune(args, TuneConfig(energy="wallclock", rounds=1,
                                            cooling=1.3))
        wall_s = time.perf_counter() - t0
        static = kern.static_of(*args)
        (entry,) = kern.cache.entries(name, kern.sig_str(static))
        # the default and the best schedule timed in turns (ABBA), 50
        # launches each, outside the search
        spec = registry.spec(name)
        pair = {"default": spec.build(Schedule(), **static),
                "best": spec.build(res.best, **static)}
        paired = {"default": [], "best": []}
        for which in ("default", "best", "best", "default"):
            paired[which].append(cuda_ms(lambda: pair[which](*args)))
        wall_tune[label] = {
            "wall_s": wall_s,
            "paired_default_ms": float(np.mean(paired["default"])),
            "paired_best_ms": float(np.mean(paired["best"])),
            "default_us": res.initial_raw * 1e6,
            "best_us": res.best_raw * 1e6, "improvement": res.improvement,
            "evals": res.evals, "best_order_is_default":
                res.best.order is None or res.best.order == tuple(
                    range(len(res.best.order))),
            "tests_passed": entry.tests_passed, **_build.STATS.snapshot()}
    launches = {"gemm_fused_leaky_relu": gf.launches,
                "flash_attention_causal": fa.launches,
                "paged_gather": pg.launches,
                "ssd_intra_chunk": sk.launches,
                "rmsnorm_fused": rk.launches,
                "flash_attention_causal_f32": fa.dtype_launches["float32"]}
    cubins = distinct_cubins()
    failures = smoke_builds["compile_failures"] \
        + sum(t["compile_failures"] for t in wall_tune.values()) \
        + _build.STATS.compile_failures
    if failures:
        raise AssertionError(f"{failures} legal orders failed to compile")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the SIP path: "
                             f"{launches}")
    out = {"tune_smoke_s": tune_s, "tune_smoke_builds": smoke_builds,
           "verify": lines, "wallclock_tune": wall_tune,
           "distinct_cubins": cubins, "compile_failures": failures,
           "launches": launches,
           "flash_launches_by_dtype": dict(fa.dtype_launches)}
    emit("sip", **out)
    return {**out, "cache": str(cache)}


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


#: the paged engine every paged serve phase runs (qwen3, dbrx, llava)
SERVE_PAGED = ServeConfig(max_len=512, capacity=8, paged=True, page_size=16,
                          prefill_chunk=128, prefix_cache=True)


class MoeCopies:
    """Counts, inside a ``with`` block, the expert copies every MoE dispatch
    routes and the copies a capacity-bound one (a whole-prompt prefill)
    drops past capacity: ``moe._dispatch_ffn`` wrapped.  The drop count
    stays on the device until read; the wrapper adds a few small kernels
    to each capacity-bound dispatch and none to the others (decode and
    chunked prefill are dropless)."""

    def __init__(self):
        self.routed = self.bound_routed = self.dispatches = 0
        self._dropped = 0

    def __enter__(self):
        inner = self._inner = moe_mod._dispatch_ffn

        def counted(p, xt, gate_vals, expert_idx, cfg, cap):
            flat = expert_idx.reshape(-1)
            self.routed += flat.numel()
            self.dispatches += 1
            if cap < xt.shape[0]:
                counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                                     device=flat.device).index_add_(
                    0, flat, torch.ones_like(flat))
                self.bound_routed += flat.numel()
                self._dropped = self._dropped + (counts - cap).clamp_min(
                    0).sum()
            return inner(p, xt, gate_vals, expert_idx, cfg, cap)
        moe_mod._dispatch_ffn = counted
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_ffn = self._inner

    @property
    def dropped(self) -> int:
        return int(self._dropped)

    def report(self) -> dict:
        return {"copies_routed": self.routed,
                "copies_routed_capacity_bound": self.bound_routed,
                "copies_dropped": self.dropped,
                "moe_dispatches": self.dispatches}


def _serve_paged(phase: str, params, cfg, prompts, budgets,
                 extras=None) -> dict:
    """The traffic once on the paged continuous engine (``SERVE_PAGED``),
    timed, after a warm-up that is not counted (the same prompts with 2
    new tokens each: it builds every prefill shape's flash schedule and
    warms cuBLAS and the allocator).  Checks that every request emits its
    budget, that flash launched once per layer and whole-prompt prefill
    and the gather twice per layer and decode or chunk step (every other
    kernel never), that chunked prefill ran, that the timed run built
    nothing, and that no page leaked past the prefix cache's refs.  An
    MoE model's copies are counted (``MoeCopies``)."""
    extras = extras or [None] * len(prompts)
    warm = ContinuousEngine(params, cfg, SERVE_PAGED)
    for p, e in zip(prompts, extras):
        warm.submit(p, 2, extra=e)
    warm.run(max_steps=10_000)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousEngine(params, cfg, SERVE_PAGED)
    tracer = obs.Tracer()
    copies = MoeCopies()
    compiles_before = _build.STATS.compiles
    reset_launches()
    t0 = time.perf_counter()
    with obs.tracing(tracer), copies:
        handles = [eng.submit(p, b, extra=e)
                   for p, b, e in zip(prompts, budgets, extras)]
        eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_causal": fa.launches,
                "paged_gather": pg.launches, **{
                    m.FUNCTION: m.launches for m in (gf, sk, rk)}}
    by_dtype = dict(fa.dtype_launches)

    events = tracer.events()
    n_prefill = sum(e["name"] == "serve.prefill" for e in events)
    decode_us = [e["dur"] for e in events if e["name"] == "serve.decode"]
    s = eng.stats
    for r, b in zip(handles, budgets):
        if len(r.tokens) != b:
            raise AssertionError(f"{phase}: request {r.uid} emitted "
                                 f"{len(r.tokens)} of {b} tokens")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{phase}: request {r.uid}: token out of "
                                 f"range")
    if s["chunk_steps"] < 1 or n_prefill < 1:
        raise AssertionError(f"{phase}: chunk_steps {s['chunk_steps']}, "
                             f"whole-prompt prefills {n_prefill}: the path "
                             f"was not covered")
    want = dict.fromkeys(launches, 0)
    want["flash_attention_causal"] = cfg.n_layers * n_prefill
    want["paged_gather"] = 2 * cfg.n_layers * (s["decode_steps"]
                                               + s["chunk_steps"])
    if launches != want or by_dtype["float32"]:
        raise AssertionError(f"{phase}: launches {launches} (flash "
                             f"{by_dtype}), expected {want} in bf16")
    builds = _build.STATS.compiles - compiles_before
    if builds:
        raise AssertionError(f"{phase}: {builds} nvcc builds in the timed run")
    if eng.pages.used_pages != len(eng.prefix):
        raise AssertionError(f"{phase}: pages leaked past the prefix "
                             f"cache's refs")
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
           "flash_launches_by_dtype": by_dtype,
           "kernel_builds_in_timed_window": builds,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.family == "moe":
        out.update(copies.report())
    return out


def phase_serve(params, cfg) -> dict:
    """The main path: qwen3-1.7b at full width, bf16, on the paged
    continuous engine with prefix sharing and chunked prefill."""
    out = _serve_paged("serve", params, cfg, *_serve_requests(cfg.vocab))
    if out["prefix_hits"] < 1:
        raise AssertionError("serve: no prefix hit: the path was not covered")
    emit("serve", **out)
    return out


def phase_serve_moe(params, cfg, full_layers: int) -> dict:
    """The MoE path: dbrx-132b at full width, cut to ``cfg.n_layers`` of
    ``full_layers`` layers, bf16, on the paged engine: top-4 of 16 experts,
    whole-prompt prefills capacity-bound (copies must drop), chunked
    prefill and decode dropless."""
    out = _serve_paged("serve_moe", params, cfg, *_serve_requests(cfg.vocab))
    if out["prefix_hits"] < 1 or out["copies_dropped"] < 1:
        raise AssertionError(f"serve_moe: prefix hits {out['prefix_hits']}, "
                             f"copies dropped {out['copies_dropped']}: the "
                             f"path was not covered")
    out["reduced"] = {"n_layers": f"{cfg.n_layers} of {full_layers}"}
    emit("serve_moe", **out)
    return out


def _vlm_embeds(prompts, d: int, seed: int) -> list[dict]:
    """One standard-normal (len, d) float32 embedding per prompt."""
    rng = np.random.default_rng(seed)
    return [{"embeds": rng.standard_normal((len(p), d)).astype(np.float32)}
            for p in prompts]


def phase_serve_vlm(params, cfg) -> dict:
    """The VLM path: llava-next-34b at full width and depth, bf16, on the
    paged engine, every prompt precomputed embeddings (seed 0): no prefix
    hit, though the 17th request shares the first's token ids."""
    prompts, budgets = _serve_requests(cfg.vocab)
    out = _serve_paged("serve_vlm", params, cfg, prompts, budgets,
                       _vlm_embeds(prompts, cfg.d_model, 0))
    if out["prefix_hits"] != 0:
        raise AssertionError(f"serve_vlm: {out['prefix_hits']} prefix hits "
                             f"for embedding prompts")
    emit("serve_vlm", **out)
    return out


def trace_totals(prof) -> tuple[list, list]:
    """(device rows, host rows) of a finished ``torch.profiler`` run, each
    ``(us, calls, name)`` sorted by time: every device event's time (kernels,
    copies, fills) summed by name, and every ATen op's self time on the
    host (its span less its direct children's on its thread) summed by
    name.  The sums ``key_averages()`` gives, read from the raw trace
    without building its event tree (which takes tens of µs an event, and
    a serve window has hundreds of thousands)."""
    dev: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    host: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    threads = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = dev[e.name()]
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
        elif e.device_type() == torch.autograd.DeviceType.CPU \
                and not e.is_async():
            threads[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), e.name()))

    def close(frame):
        end, name, children, start, n_children, child_name = frame
        if name.startswith("aten::"):
            row = host[name]
            row[0] += (end - start - children) / 1e3
            # key_averages folds an op's only child of the same name (a
            # redispatch) into it: one call, the same summed self time
            row[1] += 0 if n_children == 1 and child_name == name else 1

    for evs in threads.values():
        evs.sort(key=lambda ev: (ev[0], -ev[1]))
        # [end, name, children's ns, start, children, last child's name]
        stack = []
        for start, end, name in evs:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] += end - start
                stack[-1][4] += 1
                stack[-1][5] = name
            stack.append([end, name, 0, start, 0, None])
        while stack:
            close(stack.pop())
    return ([(us, n, k[:90]) for k, (us, n) in sorted(
                dev.items(), key=lambda kv: -kv[1][0]) if us > 0],
            [(us, n, k) for k, (us, n) in sorted(
                host.items(), key=lambda kv: -kv[1][0])])


def phase_profile(params, cfg, scfg: ServeConfig,
                  phase: str = "profile") -> dict:
    """Device time by kernel over a short serving window (8 requests of 100
    tokens, 16 new each; a VLM's prompts as embeddings), from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    eng = ContinuousEngine(params, cfg, scfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 100).astype(np.int32)
               for _ in range(8)]
    extras = (_vlm_embeds(prompts, cfg.d_model, 1)
              if cfg.input_mode == "embeddings" else [None] * len(prompts))
    warm = ContinuousEngine(params, cfg, eng.scfg)    # builds, not profiled
    warm.submit(prompts[0], 2, extra=extras[0])
    warm.run(max_steps=100)
    del warm
    for p, e in zip(prompts, extras):
        eng.submit(p, 16, extra=e)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host_ops = trace_totals(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    s = eng.stats
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "window": "8 x 100-token prompts, 16 new tokens, "
                     + ("paged" if scfg.paged else "contiguous"),
           "wall_s": wall, "device_busy_s": busy_s if rows else None,
           "device_idle_share": 1 - busy_s / wall if rows else None,
           "decode_steps": s["decode_steps"],
           "kernel_launches": sum(r[1] for r in rows),
           "top_kernels": [{"name": k, "calls": c, "ms": us / 1e3}
                           for us, c, k in rows[:12]],
           "top_host_ops": [{"op": k, "calls": c, "self_cpu_ms": us / 1e3}
                            for us, c, k in host_ops[:12]]}
    emit(phase, **out)
    return out


def _serve_pass(params, cfg, scfg: ServeConfig, store: ScheduleCache,
                prompts, budgets, recorder) -> dict:
    """The traffic once, on a fresh engine serving from ``store`` and
    recording into ``recorder``: its tokens, tokens/s, schedule swaps, and
    the decode step that follows each swap beside the step p50."""
    tracer = obs.Tracer()
    with schedule_cache(store), obs.tracing(tracer):
        eng = ContinuousEngine(params, cfg, scfg, recorder=recorder)
        t0 = time.perf_counter()
        handles = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.run(max_steps=10_000)
        # this thread's stream only: a tuning thread's work is not serving's
        torch.cuda.current_stream().synchronize()
        wall = time.perf_counter() - t0
    events = tracer.events()
    decode = [(e["ts"], e["dur"] / 1e3) for e in events
              if e["name"] == "serve.decode"]
    swaps = [e["ts"] for e in events if e["name"] == "serve.schedule_swap"]
    tokens = [list(r.tokens) for r in handles]
    return {"wall_s": wall, "tokens_per_s": sum(map(len, tokens)) / wall,
            "schedule_swaps": eng.stats["schedule_swaps"],
            "decode_step_p50_ms": float(np.percentile(
                [d for _, d in decode], 50)),
            "decode_step_after_swap_ms": [
                next(d for t, d in decode if t >= ts) for ts in swaps
                if any(t >= ts for t, _ in decode)],
            "tokens": tokens}


def _promoted_served(store: ScheduleCache, events: list[dict]) -> list[dict]:
    """Each promotion in the journal: whether its schedule is the
    signature's default, and how often the serving engines launched the
    kernel built from it (the per-schedule count of the kernel object the
    store's registry instance built for it; the tuning thread builds its
    own)."""
    rows = []
    for ev in events:
        if ev["kind"] != "promoted":
            continue
        spec = registry.spec(ev["kernel"])
        static = json.loads(ev["signature"])
        sched = Schedule.from_json(ev["schedule_sig"])
        prog = spec.program_for(sched, **static)
        kern = registry.get(ev["kernel"], store).built(static, sched)
        rows.append({
            "kernel": ev["kernel"], "workload": ev["workload"],
            "b": static["b"], "sq": static.get("sq"),
            "default": sched.resolve_order(prog) == prog.default_order()
            and dict(sched.knobs) == spec.space_for(**static).default_knobs(),
            "serving_launches": kern.launches if kern is not None else 0})
    return rows


def phase_autotune(params, cfg, workdir: Path) -> dict:
    """Live autotuning on the main path: the ``serve`` phase's engine and
    traffic, recorded into a fresh live store's AutotuneService running on
    its own thread (and CUDA stream), as ``launch.serve --autotune`` runs
    it.  After a warm-up, the traffic runs once without the service, then
    again with it
    (a fresh engine per run, same prompts) until a promotion has swapped
    into a running engine and a promoted non-default schedule has served,
    then once more after the service stopped.  Tokens must equal the
    first run's in every run."""
    scfg = SERVE_PAGED
    prompts, budgets = _serve_requests(cfg.vocab)
    d = workdir / "autotune"
    d.mkdir()
    # fresh: every entry of the live store is one of the service's
    store = ScheduleCache(str(d / "live.json"))
    recorder = obs.WorkloadRecorder(str(d / "live_mix.jsonl"))
    journal = str(d / "live.json.autotune.jsonl")
    svc = AutotuneService(
        store, source=recorder_source(recorder),
        target_for=serve_targets(cfg, scfg),
        config=AutotuneConfig(interval_s=1.0, budget=2, tune=LIVE_TUNE),
        log=EventLog(journal), device="cuda")
    builds_before = dict(_build.STATS.compiles_by_thread)
    # warm-up, not recorded or counted: the store's registry instances
    # resolve and emit every signature's default text here (loaded, not
    # compiled: the serve phase built them)
    _serve_pass(params, cfg, scfg, store, prompts, [2] * len(prompts), None)
    run = functools.partial(_serve_pass, params, cfg, scfg, store, prompts,
                            budgets, recorder)
    baseline = run()
    passes = []
    t_start = time.perf_counter()
    svc.start()
    try:
        while True:
            passes.append(run())
            served = _promoted_served(store, list(svc.log.events))
            if sum(p["schedule_swaps"] for p in passes) and any(
                    r["serving_launches"] and not r["default"]
                    for r in served):
                break
            if time.perf_counter() - t_start > 180:
                raise AssertionError(
                    f"no promoted non-default schedule served within 180 s: "
                    f"swaps {[p['schedule_swaps'] for p in passes]}, "
                    f"promotions {served}, service {svc.metrics()}")
    finally:
        svc.stop(timeout=None)
        svc.log.close()
        recorder.close()
    with_service_s = time.perf_counter() - t_start
    served = _promoted_served(store, svc.log.events)
    after = run()
    builds = {t: n - builds_before.get(t, 0)
              for t, n in _build.STATS.compiles_by_thread.items()
              if n != builds_before.get(t, 0)}

    m = svc.metrics()
    errors = [ev["error"] for ev in svc.log.events if ev["kind"] == "error"]
    if m["errors"] or errors:
        raise AssertionError(f"autotune cycles failed on the card: {errors}")
    events = load_events(journal)
    if validate_events(events):
        raise AssertionError(f"journal invalid: {validate_events(events)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obsreport_cli.main([journal, "--kind", "autotune"])
    report = buf.getvalue().splitlines()
    if rc != 0 or not any("promoted=" in ln for ln in report):
        raise AssertionError(f"obsreport --kind autotune: rc {rc} {report}")
    tuned = [ev["kernel"] for ev in events if ev["kind"] == "tuned"]
    if not set(tuned) & {fa_ops.variant_name(True, None), pg_ops.NAME}:
        raise AssertionError(f"no flash or gather target tuned: {tuned}")
    if m["promotions"] < 1 or not any(p["schedule_swaps"] for p in passes):
        raise AssertionError(f"promotions {m['promotions']}, swaps "
                             f"{[p['schedule_swaps'] for p in passes]}")
    if builds.get(threading.main_thread().name, 0):
        raise AssertionError(f"the serving thread ran nvcc: {builds}")
    for i, p in enumerate(passes + [after]):
        if p["tokens"] != baseline["tokens"]:
            raise AssertionError(f"run {i + 1}: tokens differ from the run "
                                 f"without the service")
    cycles = [ev for ev in events if ev["kind"] == "cycle"]
    keep = ("wall_s", "tokens_per_s", "schedule_swaps",
            "decode_step_p50_ms", "decode_step_after_swap_ms")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "requests": len(prompts), "token_identical": True,
           "cycles": int(m["cycles"]), "tuned": int(m["tuned"]),
           "promotions": int(m["promotions"]),
           "quarantines": int(m["quarantines"]),
           "rejections": int(m["rejections"]),
           "cycle_s": [ev["seconds"] for ev in cycles],
           "cycle_tuned": [ev["tuned"] for ev in cycles],
           "builds_by_thread": builds,
           "promoted": served, "with_service_s": with_service_s,
           "without_service": {k: baseline[k] for k in keep},
           "with_service": [{k: p[k] for k in keep} for p in passes],
           "after_service": {k: after[k] for k in keep},
           "journal_report": report}
    emit("autotune", **out)
    return out


#: the kernels the serving engine dispatches through the registry
SERVED = (fa_ops.variant_name(True, None), pg_ops.NAME)


def _input_specs(name: str, static: dict) -> list[InputSpec]:
    if name == sk_ops.NAME:
        g, q, h, n, dt = (static[k] for k in ("g", "q", "h", "n", "dtype"))
        return [InputSpec((g, q, h, static["p"]), dt), InputSpec((g, q, h), dt),
                InputSpec((g, q, n), dt), InputSpec((g, q, n), dt)]
    if name == pg_ops.NAME:
        return [InputSpec((static["p"], static["ps"], static["h"],
                           static["d"]), static["dtype"]),
                InputSpec((static["b"], static["n"]), "int32")]
    kv = InputSpec((static["b"], static["hkv"], static["skv"], static["d"]),
                   static["dtype"])
    return [InputSpec((static["b"], static["hq"], static["sq"], static["d"]),
                      static["dtype"]), kv, kv]


def put_served_schedules(path: Path, served: dict[str, list]) -> dict:
    """Persist into the store at ``path``, at every signature the engine
    served, a schedule that is not the default: a random legal order (the
    gather at its finest tiling; at its default tiling it has no legal
    move) that assembles on the card and passes 8 probabilistic tests
    against the kernel's oracle."""
    cache = ScheduleCache(str(path))
    rng = np.random.default_rng(3)
    for name, sigs in served.items():
        spec = registry.spec(name)
        for static in sigs:
            knobs = gather_tiled(static) if name == pg_ops.NAME else {}
            prog = spec.program_for(Schedule(knobs=knobs), **static)
            for seed in range(1, 65):
                order = random_legal_order(prog, seed)
                kern = spec.build(Schedule(knobs=knobs, order=order), **static)
                try:
                    kern.source()
                except UnassemblableSchedule:
                    continue
                if order != prog.default_order():
                    break
            else:
                raise AssertionError(f"{name} {static}: no assemblable "
                                     f"order besides the default")
            rep = probabilistic_test(kern, spec.oracle,
                                     _input_specs(name, static), 8, rng,
                                     device="cuda")
            if not rep.passed:
                raise AssertionError(f"{name} {static} order seed {seed}: "
                                     f"fails its oracle ({rep})")
            cache.put(name, SipKernel.sig_str(static),
                      Schedule(knobs=knobs, order=order), energy=0.0,
                      tests_passed=True, test_samples=rep.samples_run,
                      origin="random legal order")
    return {name: len(sigs) for name, sigs in served.items()}


def phase_differential(sip_cache: str, workdir: Path) -> dict:
    """Full width, 4 layers, float32: the paged continuous engine is
    token-identical to single-request Engine.generate, in fifo and reversed
    arrival, under a tuned store (the card's smoke store plus a non-default
    schedule at every signature the fifo run served, each of which the
    tuned run must resolve), and across a promotion mid-run: two requests
    in flight, one AutotuneService cycle over the engine's recorded mix
    commits into the store the engine serves from, then the other three
    arrive and must be served by the promoted flash schedule."""
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

    def run(order: str, cache: ScheduleCache | str) -> dict[str, list]:
        idxs = list(range(len(prompts)))[::-1 if order == "reversed" else 1]
        reset_launches()
        with schedule_cache(cache) as store:
            eng = ContinuousEngine(params, cfg, scfg)
            uids = {eng.submit(prompts[i], budgets[i]).uid: i for i in idxs}
            got = eng.run(max_steps=1000)
            served = {name: registry.get(name, store).served_signatures()
                      for name in SERVED}
        for uid, i in uids.items():
            if not np.array_equal(got[uid], want[i]):
                raise AssertionError(f"differential ({order}): request {i} "
                                     f"gave {got[uid].tolist()}, Engine "
                                     f"gave {want[i].tolist()}")
        stats[order] = {k: eng.stats[k] for k in (
            "prefix_hits", "chunk_steps", "decode_steps", "prefill_compiles")}
        stats[order]["launches"] = {SERVED[0]: fa.launches,
                                    SERVED[1]: pg.launches}
        stats[order]["flash_launches_by_dtype"] = dict(fa.dtype_launches)
        return served

    served = run("fifo", ScheduleCache())
    if not all(served.values()):
        raise AssertionError(f"the engine served no signature of a kernel: "
                             f"{ {k: len(v) for k, v in served.items()} }")
    run("reversed", ScheduleCache())
    tuned = workdir / "sip_served.json"
    shutil.copy(sip_cache, tuned)
    put = put_served_schedules(tuned, served)
    served_tuned = run("tuned_cache", str(tuned))
    store = ScheduleCache(str(tuned))
    resolved = {}
    for name, sigs in served_tuned.items():
        for static in sigs:
            best = store.best(name, SipKernel.sig_str(static))
            if best is None or best.order is None:
                raise AssertionError(f"tuned run: {name} {static} resolved "
                                     f"the default schedule")
        resolved[name] = len(sigs)
    if min(stats["tuned_cache"]["launches"].values()) < 1 or any(
            st["flash_launches_by_dtype"]["float32"] < 1
            for st in stats.values()):
        raise AssertionError(f"a run launched no kernel, or no float32 "
                             f"flash: {stats}")
    stats["tuned_cache"].update(schedules_put=put,
                                non_default_resolved=resolved)
    stats["autotune_swap"] = _differential_swap(params, cfg, scfg, prompts,
                                                budgets, want)
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(prompts), "token_identical": True, **stats}
    emit("differential", **out)
    return out


def _differential_swap(params, cfg, scfg: ServeConfig, prompts, budgets,
                       want) -> dict:
    """The swap run of ``differential``: a service cycle commits mid-run."""
    store = ScheduleCache()
    recorder = obs.WorkloadRecorder()
    svc = AutotuneService(
        store, source=recorder_source(recorder),
        target_for=serve_targets(cfg, scfg),
        config=AutotuneConfig(budget=2, tune=LIVE_TUNE), device="cuda")
    reset_launches()
    with schedule_cache(store):
        eng = ContinuousEngine(params, cfg, scfg, recorder=recorder)
        uids = {eng.submit(prompts[i], budgets[i]).uid: i for i in (0, 1)}
        got = {}
        for _ in range(3):
            got.update({r.uid: r.output for r in eng.step()})
        cycle = svc.run_once()              # commits while 0 and 1 decode
        swaps_before = eng.stats["schedule_swaps"]
        uids.update({eng.submit(prompts[i], budgets[i]).uid: i
                     for i in (2, 3, 4)})
        got.update(eng.run(max_steps=1000))
    for uid, i in uids.items():
        if not np.array_equal(got[uid], want[i]):
            raise AssertionError(f"differential (autotune_swap): request {i} "
                                 f"gave {got[uid].tolist()}, Engine gave "
                                 f"{want[i].tolist()}")
    served = _promoted_served(store, svc.log.events)
    if svc.metrics()["errors"] or eng.stats["schedule_swaps"] != 1 \
            or swaps_before != 0 or not any(
                r["serving_launches"] and not r["default"] for r in served):
        raise AssertionError(f"differential (autotune_swap): cycle {cycle}, "
                             f"swaps {eng.stats['schedule_swaps']}, "
                             f"promotions {served}, {svc.log.events[-1]}")
    return {"cycle": cycle, "schedule_swaps": eng.stats["schedule_swaps"],
            "promoted": served, "launches": {SERVED[0]: fa.launches,
                                             SERVED[1]: pg.launches}}


def _ssm_requests(vocab: int):
    """17 requests with prompt lengths uniform in 16-384 (request 0: 256, a
    whole chunk of the configured 256) and new tokens uniform in 16-32."""
    rng = np.random.default_rng(4)
    lens = rng.integers(16, 385, 17)
    lens[0] = 256
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts, [int(n) for n in rng.integers(16, 33, len(prompts))]


def _serve_contiguous(phase: str, params, cfg, scfg: ServeConfig, prompts,
                      budgets, per_prefill: dict[str, int],
                      names: dict[str, str]) -> dict:
    """The traffic once on the contiguous continuous engine, timed, after a
    warm-up that is not counted (the same prompts with 2 new tokens each:
    it builds the schedule of every prefill shape and warms cuBLAS and the
    allocator).  Checks that every request emits its budget, that each
    kernel launched ``per_prefill[FUNCTION]`` times per prefill dispatch
    (every other kernel 0 times) and that the timed run built nothing;
    ``names`` maps an output field to the registry name whose served
    signatures it lists."""
    warm = ContinuousEngine(params, cfg, scfg)
    for p in prompts:
        warm.submit(p, 2)
    warm.run(max_steps=10_000)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousEngine(params, cfg, scfg)
    tracer = obs.Tracer()
    compiles_before = _build.STATS.compiles
    reset_launches()
    t0 = time.perf_counter()
    with obs.tracing(tracer), schedule_cache(ScheduleCache()) as store:
        handles = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.run(max_steps=10_000)
        served = {field: registry.get(name, store).served_signatures()
                  for field, name in names.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.FUNCTION: m.launches for m in KERNEL_MODULES}

    events = tracer.events()
    n_prefill = sum(e["name"] == "serve.prefill" for e in events)
    decode_us = [e["dur"] for e in events if e["name"] == "serve.decode"]
    s = eng.stats
    for r, b in zip(handles, budgets):
        if len(r.tokens) != b:
            raise AssertionError(f"{phase}: request {r.uid} emitted "
                                 f"{len(r.tokens)} of {b} tokens")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{phase}: request {r.uid}: token out of "
                                 f"range")
    want = {m.FUNCTION: per_prefill.get(m.FUNCTION, 0) * n_prefill
            for m in KERNEL_MODULES}
    if launches != want or n_prefill < 1:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    builds = _build.STATS.compiles - compiles_before
    if builds:
        raise AssertionError(f"{phase}: {builds} nvcc builds in the timed run")
    ttft = [r.admitted_at - r.submitted_at for r in handles]
    tokens = sum(len(r.tokens) for r in handles)
    return {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "requests": len(handles), "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_ms": _pct_ms(ttft, 50), "ttft_p99_ms": _pct_ms(ttft, 99),
            "decode_step_p50_ms": float(np.percentile(decode_us, 50)) / 1e3,
            "prefill_s": s["prefill_s"], "decode_s": s["decode_s"],
            "prefill_frac": eng.metrics()["prefill_frac"],
            "prefill_dispatches": n_prefill, "decode_steps": s["decode_steps"],
            "prefill_compiles": s["prefill_compiles"], **served,
            "launches": launches,
            "flash_launches_by_dtype": dict(fa.dtype_launches),
            "kernel_builds_in_timed_window": builds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve_ssm(params, cfg) -> dict:
    """The SSM path: mamba2-2.7b at full width, bf16, on the contiguous
    continuous engine with per-slot conv and SSD states."""
    prompts, budgets = _ssm_requests(cfg.vocab)
    out = _serve_contiguous(
        "serve_ssm", params, cfg, ServeConfig(max_len=512, capacity=8),
        prompts, budgets, {sk.FUNCTION: cfg.n_layers},
        {"ssd_signatures": sk_ops.NAME})
    chunks = sorted({sig["q"] for sig in out["ssd_signatures"]})
    if 256 not in chunks:
        raise AssertionError(f"no prefill ran the q = 256 chunk: "
                             f"{out['ssd_signatures']}")
    emit("serve_ssm", **out)
    return out


def phase_serve_hybrid(params, cfg) -> dict:
    """The hybrid path: zamba2-7b at full width and depth, bf16, on the
    contiguous engine: per prefill the SSD kernel in each of the 81 mamba
    blocks and flash (D 112, MHA) in the shared block of each group that
    runs it."""
    n_on = sum(M.hybrid_flags(cfg))
    prompts, budgets = _ssm_requests(cfg.vocab)
    out = _serve_contiguous(
        "serve_hybrid", params, cfg, ServeConfig(max_len=512, capacity=8),
        prompts, budgets, {sk.FUNCTION: cfg.n_layers, fa.FUNCTION: n_on},
        {"ssd_signatures": sk_ops.NAME,
         "flash_signatures": fa_ops.variant_name(True, None)})
    if 256 not in {sig["q"] for sig in out["ssd_signatures"]}:
        raise AssertionError(f"no prefill ran the q = 256 chunk: "
                             f"{out['ssd_signatures']}")
    if {(sig["h"], sig["n"], sig["p"]) for sig in out["ssd_signatures"]} \
            != {(cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)} or {
                (sig["hq"], sig["hkv"], sig["d"], sig["dtype"])
                for sig in out["flash_signatures"]} != {
                (cfg.n_heads, cfg.n_kv_heads, cfg.hd, "bfloat16")}:
        raise AssertionError(f"serve_hybrid: served signatures {out}")
    out["attention_groups"] = n_on
    emit("serve_hybrid", **out)
    return out


def _swa_requests(vocab: int):
    """7 requests with prompts uniform in 16-384 and 16-32 new tokens, one
    of 4,500 tokens (longer than the 4,096 window) with 16, and one of
    4,070 with 48, whose decode wraps the 4,096-slot ring."""
    rng = np.random.default_rng(6)
    lens = [int(n) for n in rng.integers(16, 385, 7)] + [4500, 4070]
    budgets = [int(n) for n in rng.integers(16, 33, 7)] + [16, 48]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts, budgets


def phase_serve_swa(params, cfg) -> dict:
    """The sliding-window path: h2o-danube-1.8b at full width and depth,
    bf16, on the contiguous engine with a 4,096-slot KV ring per slot:
    flash (D 80, GQA 4:1, window 4096) in each layer of every prefill."""
    prompts, budgets = _swa_requests(cfg.vocab)
    out = _serve_contiguous(
        "serve_swa", params, cfg, ServeConfig(max_len=4608, capacity=4),
        prompts, budgets, {fa.FUNCTION: cfg.n_layers},
        {"flash_signatures": fa_ops.variant_name(True, cfg.window)})
    sigs = out["flash_signatures"]
    if {(sig["hq"], sig["hkv"], sig["d"], sig["window"], sig["dtype"])
            for sig in sigs} != {(cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                  cfg.window, "bfloat16")} \
            or max(sig["sq"] for sig in sigs) <= cfg.window:
        raise AssertionError(f"serve_swa: served signatures {sigs}")
    out["kv_ring"] = M.kv_cache_len(cfg, 4608)
    emit("serve_swa", **out)
    return out


def _differential(phase: str, cfg, prompts, budgets, scfg: ServeConfig,
                  names: tuple[str, ...], sip_cache: str, workdir: Path, *,
                  extras=None, params=None) -> dict:
    """``cfg`` (float32; ``params``, or seed 1's) on the continuous engine
    ``scfg``, token-identical to single-request Engine.generate, in fifo
    and reversed arrival, and under the card's smoke store plus a
    non-default schedule at every signature of ``names`` the fifo run
    served, each of which the tuned run must resolve and launch.
    ``extras`` gives each request its extra inputs (a VLM's embeddings)."""
    if params is None:
        params = M.init_lm(cfg, seed=1, device="cuda")
    extras = extras or [None] * len(prompts)
    ref = Engine(params, cfg, ServeConfig(max_len=scfg.max_len))
    want = [ref.generate(p[None], b, extra_inputs=e and {
        k: v[None] for k, v in e.items()})[0]
        for p, b, e in zip(prompts, budgets, extras)]
    stats = {}

    def run(order: str, cache: ScheduleCache | str):
        idxs = list(range(len(prompts)))[::-1 if order == "reversed" else 1]
        reset_launches()
        with schedule_cache(cache) as store:
            eng = ContinuousEngine(params, cfg, scfg)
            uids = {eng.submit(prompts[i], budgets[i], extra=extras[i]).uid: i
                    for i in idxs}
            got = eng.run(max_steps=1000)
            kerns = {name: registry.get(name, store) for name in names}
            served = {name: k.served_signatures() for name, k in kerns.items()}
        for uid, i in uids.items():
            if not np.array_equal(got[uid], want[i]):
                raise AssertionError(f"{phase} ({order}): request {i} gave "
                                     f"{got[uid].tolist()}, Engine gave "
                                     f"{want[i].tolist()}")
        stats[order] = {k: eng.stats[k] for k in (
            "decode_steps", "prefill_compiles") + (
            ("prefix_hits", "chunk_steps") if scfg.paged else ())}
        stats[order]["launches"] = {m.FUNCTION: m.launches
                                    for m in KERNEL_MODULES}
        stats[order]["flash_launches_by_dtype"] = dict(fa.dtype_launches)
        return served, kerns

    served, _ = run("fifo", ScheduleCache())
    if not all(served.values()):
        raise AssertionError(f"{phase}: the engine served no signature of a "
                             f"kernel: { {k: len(v) for k, v in served.items()} }")
    run("reversed", ScheduleCache())
    tuned = workdir / f"sip_served_{phase}.json"
    shutil.copy(sip_cache, tuned)
    put = put_served_schedules(tuned, served)
    served_tuned, kerns = run("tuned_cache", str(tuned))
    store = ScheduleCache(str(tuned))
    launched = {}
    for name, sigs in served_tuned.items():
        for static in sigs:
            best = store.best(name, SipKernel.sig_str(static))
            if best is None or best.order is None:
                raise AssertionError(f"{phase} tuned run: {name} {static} "
                                     f"resolved the default schedule")
            kern = kerns[name].built(static, best)
            if kern is None or kern.launches < 1:
                raise AssertionError(f"{phase} tuned run: {name} {static} "
                                     f"never launched its schedule")
        launched[name] = len(sigs)
    stats["tuned_cache"].update(schedules_put=put,
                                non_default_resolved_and_launched=launched)
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(prompts), "token_identical": True,
           "served": served, **stats}
    return out


def phase_differential_ssm(sip_cache: str, workdir: Path) -> dict:
    """mamba2 at full width cut to 4 layers, float32: the contiguous
    continuous engine against Engine.generate (``_differential``) at the
    SSD's served signatures."""
    cfg = dataclasses.replace(configs.get("mamba2-2.7b"), n_layers=4,
                              dtype="float32")
    rng = np.random.default_rng(5)
    # 256: a whole configured chunk; two prompts of 70 share one prefill
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (23, 70, 256, 45, 70)]
    out = _differential(
        "differential_ssm", cfg, prompts, [10, 8, 12, 9, 11],
        ServeConfig(max_len=512, capacity=3), (sk_ops.NAME,), sip_cache,
        workdir)
    emit("differential_ssm", **out)
    return out


def phase_differential_hybrid(sip_cache: str, workdir: Path) -> dict:
    """zamba2 at full width cut to 13 layers with the shared block on every
    2nd group (groups [off, on] and one trailing layer), float32, against
    Engine.generate at the SSD's and flash's served signatures."""
    cfg = dataclasses.replace(configs.get("zamba2-7b"), n_layers=13,
                              hybrid_attn_every=2, dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (23, 70, 256, 45, 70)]
    out = _differential(
        "differential_hybrid", cfg, prompts, [10, 8, 12, 9, 11],
        ServeConfig(max_len=512, capacity=3),
        (sk_ops.NAME, fa_ops.variant_name(True, None)), sip_cache, workdir)
    out["attention_flags"] = M.hybrid_flags(cfg)
    emit("differential_hybrid", **out)
    return out


def phase_differential_swa(sip_cache: str, workdir: Path) -> dict:
    """h2o-danube at full width cut to 4 layers, float32, window 4096 kept:
    a prompt past the window and a decode that wraps the ring, against
    Engine.generate at flash's served signatures."""
    cfg = dataclasses.replace(configs.get("h2o-danube-1.8b"), n_layers=4,
                              dtype="float32")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (23, 4500, 70, 4070, 45)]
    out = _differential(
        "differential_swa", cfg, prompts, [10, 8, 12, 40, 9],
        ServeConfig(max_len=4608, capacity=3),
        (fa_ops.variant_name(True, cfg.window),), sip_cache, workdir)
    emit("differential_swa", **out)
    return out


#: the paged differentials' engine: capacity 3, chunks of 64, prefix
#: sharing; the kernels the paged engine dispatches through the registry
DIFF_PAGED = ServeConfig(max_len=128, capacity=3, paged=True, page_size=16,
                         prefill_chunk=64, prefix_cache=True)


def _diff_paged_prompts(vocab: int, seed: int):
    """Prompts of 23, 70, 23, 45 and 70 tokens: the two 23s prefill as one
    group, the 45 alone, the 70s in chunks, the last sharing the second's
    first 40 tokens (a prefix hit); 8-12 new tokens."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (23, 70, 23, 45, 70)]
    prompts[4] = np.concatenate([prompts[1][:40],
                                 prompts[4][40:]]).astype(np.int32)
    return prompts, [10, 8, 12, 9, 11]


def phase_differential_moe(sip_cache: str, workdir: Path) -> dict:
    """dbrx at full width cut to 2 layers, float32, on the paged engine.
    (a) At capacity_factor = n_experts / top_k (4.0) no dispatch drops a
    copy: the engine against Engine.generate (``_differential``) at
    flash's and the gather's served signatures.  (b) At the config's own
    1.25 grouped and single prefills drop copies (counted), so the engine
    is held to itself: the traffic twice through one engine (no prefix
    cache, so both passes dispatch alike) gives bitwise equal tokens."""
    full = configs.get("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
    params = M.init_lm(cfg, seed=1, device="cuda")
    prompts, budgets = _diff_paged_prompts(cfg.vocab, 9)
    dropless = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    out = _differential("differential_moe", dropless, prompts, budgets,
                        DIFF_PAGED, SERVED, sip_cache, workdir,
                        params=params)
    eng = ContinuousEngine(params, cfg, dataclasses.replace(
        DIFF_PAGED, prefix_cache=False))
    passes = []
    for _ in range(2):
        with MoeCopies() as copies:
            uids = [eng.submit(p, b).uid for p, b in zip(prompts, budgets)]
            got = eng.run(max_steps=1000)
        passes.append({"tokens": [got[u].tolist() for u in uids],
                       **copies.report()})
    if passes[0]["tokens"] != passes[1]["tokens"] \
            or min(p["copies_dropped"] for p in passes) < 1:
        raise AssertionError(f"differential_moe (b): tokens equal "
                             f"{passes[0]['tokens'] == passes[1]['tokens']}, "
                             f"copies dropped "
                             f"{[p['copies_dropped'] for p in passes]}")
    out.update(capacity_factor=dropless.capacity_factor,
               reduced={"n_layers": f"{cfg.n_layers} of {full.n_layers}"},
               at_1_25={"bitwise_repeatable": True, "passes": [
                   {k: v for k, v in p.items() if k != "tokens"}
                   for p in passes]})
    emit("differential_moe", **out)
    return out


def phase_differential_vlm(sip_cache: str, workdir: Path) -> dict:
    """llava at full width cut to 4 layers, float32, embedding prompts
    (seed 1) on the paged engine against Engine.generate at flash's and
    the gather's served signatures: the prefix-sharing request gets no
    hit."""
    full = configs.get("llava-next-34b")
    cfg = dataclasses.replace(full, n_layers=4, dtype="float32")
    prompts, budgets = _diff_paged_prompts(cfg.vocab, 10)
    out = _differential("differential_vlm", cfg, prompts, budgets,
                        DIFF_PAGED, SERVED, sip_cache, workdir,
                        extras=_vlm_embeds(prompts, cfg.d_model, 1))
    hits = [st["prefix_hits"] for st in out.values()
            if isinstance(st, dict) and "prefix_hits" in st]
    if any(hits):
        raise AssertionError(f"differential_vlm: prefix hits {hits}")
    out["reduced"] = {"n_layers": f"{cfg.n_layers} of {full.n_layers}"}
    emit("differential_vlm", **out)
    return out


def _path_launches(path: dict, name: str) -> int:
    """A kernels-line row's launches on a serve path: flash by dtype."""
    if name.startswith(fa.FUNCTION):
        return path["flash_launches_by_dtype"][
            "float32" if name.endswith("_f32") else "bfloat16"]
    return path["launches"][name]


def kernels_line(gemm: dict, flash: dict, gather: dict, ssd: dict,
                 rms: dict, sip: dict, serve: dict, serve_ssm: dict,
                 serve_hybrid: dict, serve_swa: dict, serve_moe: dict,
                 serve_vlm: dict) -> dict:
    """One row per kernel, its launches from its own main path: the bf16
    flash kernel's from ``serve``, the float32 one's from ``sip``; beside
    them each row's launches on the hybrid, sliding-window, MoE and VLM
    serve paths."""
    rows = []
    for mod, source, name, res, path in (
            (gf, gf.SOURCE, "gemm_fused_leaky_relu", gemm, sip),
            (fa, fa.SOURCE, "flash_attention_causal", flash, serve),
            (fa, fa.SOURCE_F32, "flash_attention_causal_f32", flash["f32"],
             sip),
            (pg, pg.SOURCE, "paged_gather", gather, serve),
            (sk, sk.SOURCE, "ssd_intra_chunk", ssd, serve_ssm),
            (rk, rk.SOURCE, "rmsnorm_fused", rms, sip)):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": mod.REPLACES,
                     "launches": path["launches"][name],
                     "launches_hybrid": _path_launches(serve_hybrid, name),
                     "launches_swa": _path_launches(serve_swa, name),
                     "launches_moe": _path_launches(serve_moe, name),
                     "launches_vlm": _path_launches(serve_vlm, name),
                     "max_abs_err": res["max_abs_err"],
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
    kernels.load_all()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm = phase_gemm(gen)
    flash = phase_flash(gen)
    gather = phase_gather(gen)
    ssd = phase_ssd(gen)
    rms = phase_rmsnorm(gen)
    workdir = _build.BUILD_DIR.parent / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    sip = phase_sip(workdir)
    cfg = configs.get("qwen3-1.7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve = phase_serve(params, cfg)
    phase_profile(params, cfg, SERVE_PAGED)
    phase_autotune(params, cfg, workdir)
    del params
    torch.cuda.empty_cache()
    phase_differential(sip["cache"], workdir)
    cfg = configs.get("mamba2-2.7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_ssm = phase_serve_ssm(params, cfg)
    phase_profile(params, cfg, ServeConfig(max_len=512, capacity=8),
                  phase="profile_ssm")
    del params
    torch.cuda.empty_cache()
    phase_differential_ssm(sip["cache"], workdir)
    cfg = configs.get("zamba2-7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_hybrid = phase_serve_hybrid(params, cfg)
    phase_profile(params, cfg, ServeConfig(max_len=512, capacity=8),
                  phase="profile_hybrid")
    del params
    torch.cuda.empty_cache()
    phase_differential_hybrid(sip["cache"], workdir)
    cfg = configs.get("h2o-danube-1.8b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_swa = phase_serve_swa(params, cfg)
    phase_profile(params, cfg, ServeConfig(max_len=4608, capacity=4),
                  phase="profile_swa")
    del params
    torch.cuda.empty_cache()
    phase_differential_swa(sip["cache"], workdir)
    cfg = configs.get("dbrx-132b")
    n_full, cfg = cfg.n_layers, dataclasses.replace(cfg, n_layers=8)
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_moe = phase_serve_moe(params, cfg, n_full)
    phase_profile(params, cfg, SERVE_PAGED, phase="profile_moe")
    del params
    torch.cuda.empty_cache()
    phase_differential_moe(sip["cache"], workdir)
    cfg = configs.get("llava-next-34b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_vlm = phase_serve_vlm(params, cfg)
    phase_profile(params, cfg, SERVE_PAGED, phase="profile_vlm")
    del params
    torch.cuda.empty_cache()
    phase_differential_vlm(sip["cache"], workdir)
    print(json.dumps(kernels_line(gemm, flash, gather, ssd, rms, sip, serve,
                                  serve_ssm, serve_hybrid, serve_swa,
                                  serve_moe, serve_vlm)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
