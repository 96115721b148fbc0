"""Chip smoke of the PyTorch/CUDA port: build every emitted kernel, hold each
against its plain version at its default schedule and at seeded random legal
orders, run the SIP loop on the card (smoke tune, verify, a wall-clock tune
of each kernel), serve qwen3-1.7b, dbrx-132b (MoE, 8 of its 40 layers) and
llava-next-34b (VLM, embedding prompts) at full width through the paged
continuous engine, and mamba2-2.7b, zamba2-7b (hybrid), h2o-danube-1.8b
(sliding window) and seamless-m4t-large-v2 (encoder-decoder, 4,096-frame
contexts) at full width through the contiguous one, serve qwen3-1.7b
tensor-parallel over 2 ranks (processes sharing the one card over gloo;
exact and int8-compressed seams) and hold 2- and 4-rank serving to
one-device generation, hold qwen3 with padded
heads to the unpadded model, serve mamba2-2.7b at full width (16 of its
64 layers) over 2 ranks through the GSPMD layout (each rank its blocks, a layer gathered at a
time) and zamba2, seamless and padded or forced qwen3 at small depth
against one-device generation, tune live beside a 2-rank qwen3 engine, train qwen3-1.7b at full width (AdamW, float32
master weights, bf16 compute; no kernel launches on the training path, as
the reference trains with none), hold training on the card to the CPU's,
resume a crashed supervised run from its checkpoint to the uninterrupted
run's exact state, run the multi-pod dry run's CLI on six production
cells (fake tensors, no device) and hold the dry run's predictions to
what the card ran, and print one JSON line per phase.  Every one-device
continuous engine decodes through its captured step graph and prefills
through captured prefill and chunk graphs once it has seen a shape
``CAPTURE_AT`` times (``serve/graphs.py``); ``serve_graphs`` pairs them with eager dispatch on
qwen3-1.7b and mamba2-2.7b.  ``train`` steps through a captured
``TrainGraph`` (``train/graphs.py``) and pairs it with eager steps.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; imports only ``repro_torch``
(from ``src/`` beside this file).  Exits non-zero, printing no result, when
there is no card or any phase fails.  The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import io
import itertools
import json
import math
import os
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
                                  EventLog, Staging, load_events,
                                  recorder_source, serve_targets,
                                  validate_events)
from repro_torch.core import (Schedule, ScheduleCache, SipKernel,  # noqa: E402
                              TuneConfig, registry, schedule_cache)
from repro_torch.core.energy import (UnassemblableSchedule,  # noqa: E402
                                     device_seconds)
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.core.testing import InputSpec, probabilistic_test  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_model  # noqa: E402
from repro_torch.dist import partition, pipeline, spawn  # noqa: E402
from repro_torch.dist import tp as tp_mod  # noqa: E402
from repro_torch.ft import (ChaosEngine, FaultPlan, FTConfig,  # noqa: E402
                            FTManager, Supervisor)
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
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import obsreport as obsreport_cli  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import tune as tune_cli  # noqa: E402
from repro_torch.launch import verify as verify_cli  # noqa: E402
from repro_torch.launch.mesh import mesh_for  # noqa: E402
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      ServeConfig)
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.graphs import TrainGraph  # noqa: E402

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
    """Every kernel's launch counts to 0 (flash's by variant too)."""
    for mod in KERNEL_MODULES:
        mod.launches = 0
    fa.variant_launches.update(dict.fromkeys(fa.variant_launches, 0))


#: the kernels line's flash rows by the (causal, dtype) of the launch
FLASH_ROWS = {(True, "bfloat16"): "flash_attention_causal",
              (True, "float32"): "flash_attention_causal_f32",
              (False, "bfloat16"): "flash_attention",
              (False, "float32"): "flash_attention_f32"}


def row_launches() -> dict[str, int]:
    """Every kernel's launches since the last reset under its kernels-line
    row's name (flash by variant and dtype)."""
    return {**{FLASH_ROWS[key]: n for key, n in fa.variant_launches.items()},
            **{m.FUNCTION: m.launches for m in (gf, pg, sk, rk)}}


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
    (1, 32, 8, 300, 300, 80, True, 64),         # h2o-danube's, windowed
    # seamless's decoder prompts (4-40 tokens, padded to 64), one and the
    # grouped pair, and its encoder at the grouped pair
    (1, 16, 16, 64, 64, 64, True, None),
    (2, 16, 16, 64, 64, 64, True, None),
    (2, 16, 16, 4096, 4096, 64, False, None),
    # a rank's share of qwen3's heads under tensor parallelism: 8 of 16
    # and 4 of 8 kv heads at mesh 2 (serve_tp), 4 and 2 at mesh 4
    # (differential_tp)
    (1, 8, 4, 384, 384, 128, True, None),
    (3, 8, 4, 128, 128, 128, True, None),
    (2, 4, 2, 64, 64, 128, True, None)]
#: (p, ps, h, d, b, n): smoke, deploy and the serve phase's store and table,
#: and serve_tp's: a rank's 4 of the 8 kv heads
GATHER_SHAPES = [(8, 8, 2, 8, 2, 4), (64, 16, 4, 32, 8, 8),
                 (257, 16, 8, 128, 8, 32), (257, 16, 4, 128, 8, 32)]
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
#: the SSD at the head counts a rank runs when the mixer's heads split
#: along "model": mamba2's 80 (state 128) and zamba2's 112 (state 64) cut
#: 16 and 2 ways (the odd 5 and 7 leave zero-filled heads in the last head
#: group of every block), one 256-row chunk
SSD_SPLIT_SHAPES = {"mamba2_16way": (1, 256, 5, 64, 128),
                    "mamba2_2way": (1, 256, 40, 64, 128),
                    "zamba2_16way": (1, 256, 7, 64, 64),
                    "zamba2_2way": (1, 256, 56, 64, 64)}


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
            "count": torch.cuda.device_count(),
            # the builds run two nvcc a core: what the host offers
            "cpu_count": os.cpu_count(),
            "cpu_affinity": len(os.sched_getaffinity(0))}
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
    # distinct_cubins' texts too, in the same pool of builds
    distinct = [t for _, more, _ in distinct_texts().values() for t in more]
    _build.STATS.reset()
    t0 = time.perf_counter()
    _build.compile_many(texts + distinct)
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
           "distinct_cubins_texts": len(distinct),
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
    encoder = flash_encoder_shape(gen)
    out = {"cases": results, "max_abs_err_f32": worst[F32],
           "max_abs_err_bf16": worst[BF16], "timed_bf16_causal": timed,
           "timed_f32_causal": timed_f32,
           "timed_bf16_serve_shapes": flash_serve_shapes(gen),
           "timed_bf16_encoder": encoder,
           "timed_bf16_encoder_rank": flash_encoder_shape(
               gen, FLASH_ENCODER_RANK_SHAPE)}
    emit("flash_attention", **out)
    return {**out, **timed["b4_s128"], "max_abs_err": worst[BF16],
            "f32": {**timed_f32["b4_s128"], "max_abs_err": worst[F32]},
            "bidirectional": encoder}


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


#: bf16 bidirectional flash at seamless-m4t's encoder: (b, hq, hkv, s, d)
FLASH_ENCODER_SHAPE = (1, 16, 16, 4096, 64)
#: the same at a rank's heads when the encoder's split along "model" over
#: the mesh serving job's 2 ranks (8 of 16)
FLASH_ENCODER_RANK_SHAPE = (1, 8, 8, 4096, 64)


def flash_encoder_shape(gen, shape=FLASH_ENCODER_SHAPE) -> dict:
    """The bidirectional kernel through the model's entry point at the
    encoder's ``shape`` (b, hq, hkv, frames, head_dim: MHA, 4,096 frames,
    head_dim 64, all 16 heads or a rank's 8), bf16, against its plain
    version, the bound and SDPA.  Each row's relative error must be
    within ``ROW_RTOL``, and the call with the last key tile zeroed must
    fail that check."""
    b, hq, hkv, s, d = shape
    q = _randn((b, hq, s, d), BF16, gen)
    k = _randn((b, hkv, s, d), BF16, gen)
    v = _randn((b, hkv, s, d), BF16, gen)

    def kern():
        return fa.flash_attention(q, k, v, causal=False)

    def plain():
        return fa_ref.attention(q, k, v, causal=False)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)
    before = dict(fa.variant_launches)
    got, want = kern(), plain()
    if fa.variant_launches[False, "bfloat16"] != \
            before[False, "bfloat16"] + 1:
        raise AssertionError("flash at the encoder shape: the "
                             "bidirectional kernel did not launch")
    err = compare(got, want, BF16, "flash bidirectional encoder shape")
    rel = row_rel_err(got, want)
    control = row_rel_err(fa.flash_attention(
        q, _zero_last_tile(k), _zero_last_tile(v), causal=False), want)
    del got
    if rel > ROW_RTOL or control <= ROW_RTOL:
        raise AssertionError(f"flash at the encoder shape: row error {rel} "
                             f"against {ROW_RTOL}, control {control}")
    bound_ms, bound_by = attention_bound_ms(b, hq, hkv, s, s, d, 2, False,
                                            None, PEAK_FLOPS[BF16])
    return {"shape": [b, hq, hkv, s, d], "causal": False,
            "max_abs_err": err, "max_abs_want": want.abs().max().item(),
            "row_rel_err": rel, "row_rtol": ROW_RTOL,
            "controls_row_rel_err": {"last_kv_tile_zeroed": control},
            "ms": cuda_ms(kern, iters=20),
            "plain_ms": cuda_ms(plain, iters=5, warmup=1),
            "library_ms": cuda_ms(library, iters=20),
            "library_max_abs_err": (library().float()
                                    - want.float()).abs().max().item(),
            "bound_ms": bound_ms, "bound_by": bound_by}


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
           "timed_f32": timed, "split_heads": ssd_split_heads(gen)}
    emit("ssd_intra_chunk", **out)
    return {**out, **timed["g1_q256_h80_p64_n128"]}


def ssd_split_heads(gen) -> dict:
    """The SSD at ``SSD_SPLIT_SHAPES``, float32 and bfloat16, against its
    plain version on the same (rounded) inputs in float32: each dtype's
    tolerance, the largest per-row error and the kernel's head groups;
    its time (CUDA events over 50 launches) beside the float32 bound of
    ``ssd_bound_ms``."""
    out = {}
    for name, shape in SSD_SPLIT_SHAPES.items():
        args = ssd_inputs(*shape, gen)
        bound_ms, bound_by = ssd_bound_ms(*shape)
        for dt in (F32, BF16):
            mine = [a.to(dt) for a in args]
            kern = ssd_kernel(ssd_static(*shape, dtype=dt))
            got = kern(*mine)
            want = sk_ref.intra_chunk(*[a.float() for a in mine])
            g, q, h = shape[:3]
            out[f"{name}_{_dt(dt)}"] = {
                "heads": h, "heads_per_block": kern.layout["HG"],
                "grid": list(kern.grid(g, q, h, kern.br)),
                "max_abs_err": compare(got, want, dt, f"ssd {name} {dt}"),
                "max_row_rel_err": row_rel_err(got, want),
                "max_abs_want": want.abs().max().item(),
                "ms": cuda_ms(lambda: kern(*mine)),
                "bound_ms": bound_ms, "bound_by": bound_by}
    return out


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


@functools.cache
def distinct_texts() -> dict:
    """For each kernel of ``distinct_cubins``: (its distinct random legal
    orders of 16 drawn, the (function, text) of each that fits, the
    number the shared-memory check rejected)."""
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
    emitted = {}
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
        emitted[label] = (len(orders), texts, rejected)
    return emitted


def distinct_cubins() -> dict:
    """Do 16 random legal orders of each kernel survive nvcc/ptxas as 16
    different binaries?  (``phase_build`` compiled their texts.)"""
    emitted = distinct_texts()
    paths = iter(_build.compile_many(
        [t for _, texts, _ in emitted.values() for t in texts]))
    out = {}
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for label, (n_orders, texts, rejected) in emitted.items():
            mine = [next(paths) for _ in texts]
            cubins = {hashlib.sha256(p.read_bytes()).hexdigest()
                      for p in mine}
            sass = set(pool.map(_sass_hash, mine))
            out[label] = {"random_orders": 16, "distinct_orders": n_orders,
                          "smem_rejected": rejected,
                          "distinct_texts": len({t for _, t in texts}),
                          "distinct_cubins": len(cubins),
                          "distinct_sass": None if None in sass
                          else len(sass)}
    return out


#: the wall-clock tunes' cooling factor L (T <- T / L a step, from 1 to
#: 0.02): 7 evaluations a tune
WALL_TUNE_COOLING = 2.0


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
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = verify_cli.main(["--suite", "smoke", "--cache", str(cache)])
    verify_s = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[verify] ") and "workload(s)" not in ln]
    smoke = [w for spec in registry.specs() for w in spec.workloads_in("smoke")]
    if rc != 0 or len(lines) != len(smoke) or not all(
            ln.startswith("[verify] PASS") and "tuned schedule" in ln
            for ln in lines):
        raise AssertionError(f"verify on the card's smoke store: rc {rc}")

    # one wall-clock tune per kernel at its main-path shape: the paper's
    # gemm (benchmarks/table3_gemm.py), a serve prefill, the serve gather;
    # one round cooled by 2 a step (7 evaluations: each compiles one
    # schedule, one at a time, and tests it)
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
                                            cooling=WALL_TUNE_COOLING))
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
    launches = row_launches()
    t0 = time.perf_counter()
    cubins = distinct_cubins()
    cubins_s = time.perf_counter() - t0
    failures = smoke_builds["compile_failures"] \
        + sum(t["compile_failures"] for t in wall_tune.values()) \
        + _build.STATS.compile_failures
    if failures:
        raise AssertionError(f"{failures} legal orders failed to compile")
    # the SIP path tunes and verifies causal flash only: the bidirectional
    # rows are reported, not required
    if min(n for name, n in launches.items() if name not in (
            "flash_attention", "flash_attention_f32")) < 1:
        raise AssertionError(f"a kernel never launched on the SIP path: "
                             f"{launches}")
    out = {"tune_smoke_s": tune_s, "tune_smoke_builds": smoke_builds,
           "verify": lines, "verify_s": verify_s, "wallclock_tune": wall_tune,
           "wallclock_tune_cooling": WALL_TUNE_COOLING,
           "distinct_cubins": cubins, "distinct_cubins_s": cubins_s,
           "compile_failures": failures,
           "launches": launches}
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
    """Counts, over a ``with`` block, the expert copies every MoE dispatch
    routes and the copies a capacity-bound one (a whole-prompt prefill)
    drops past capacity: ``moe._dispatch_ffn`` wrapped for the block and
    restored after it.  The counts live on the device, in one accumulator
    that the wrapper adds to with a few small kernels a dispatch, so a
    captured step's replays count as its eager dispatches do (its capture
    recorded the wrapper's kernels): a graph captured in one block counts
    in the next, and outside every block runs its counting kernels into
    an accumulator no one reads (``_uncounted_replay_ms`` measures what
    they cost a decode step).  Each block reports the accumulator's change
    over it."""

    #: [routed, routed in capacity-bound dispatches, dispatches, dropped]
    _acc: torch.Tensor | None = None

    def __enter__(self):
        if MoeCopies._acc is None:
            MoeCopies._acc = torch.zeros(4, dtype=torch.int64, device="cuda")
        inner = self._inner = moe_mod._dispatch_ffn

        def counted(p, xt, gate_vals, expert_idx, cfg, cap):
            acc, n = MoeCopies._acc, expert_idx.numel()
            acc[0].add_(n)
            acc[2].add_(1)
            if cap < xt.shape[0]:
                flat = expert_idx.reshape(-1)
                counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                                     device=flat.device).index_add_(
                    0, flat, torch.ones_like(flat))
                acc[1].add_(n)
                acc[3].add_((counts - cap).clamp_min(0).sum())
            return inner(p, xt, gate_vals, expert_idx, cfg, cap)
        moe_mod._dispatch_ffn = counted
        self._start = MoeCopies._acc.clone()
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_ffn = self._inner
        torch.cuda.synchronize()
        self._counts = (MoeCopies._acc - self._start).tolist()

    @property
    def dropped(self) -> int:
        return int(self._counts[3])

    def report(self) -> dict:
        routed, bound, dispatches, dropped = self._counts
        return {"copies_routed": routed,
                "copies_routed_capacity_bound": bound,
                "copies_dropped": dropped, "moe_dispatches": dispatches}


def _by_function(counts) -> collections.Counter:
    """(kernel object, variant) -> launches, summed by kernel function."""
    out = collections.Counter()
    for (kern, _), n in counts.items():
        out[sys.modules[type(kern).__module__].FUNCTION] += n
    return out


def graph_stats(eng: ContinuousEngine) -> dict | None:
    """The engine's captured steps after its run: the decode step's
    captures, replays, pool bytes, the launches its replays credited, by
    kernel, and its device ms (CUDA events around 10 back-to-back replays
    of the bare graph, which advance the finished engine's caches and
    count nothing); the prefill and chunk steps' captures, replays, shared
    pool bytes and credited launches; the traffic's whole-prompt prefill
    groups, the distinct (G, S, extras) shapes among them and the share of
    groups whose shape was seen before (``repeat_share``: the most a graph
    per shape could replay, were every shape captured on its first
    sighting); None under eager dispatch."""
    g = eng.graph
    if g is None:
        return None
    pre = eng.prefill_graphs
    credited = _by_function({k: n * g.replays for k, n in g.credits.items()})
    whole = [n for key, n in pre.sightings.items() if key[0] == "prefill"]
    return {"captures": g.captures, "replays": g.replays,
            "pool_bytes": g.pool_bytes(), "credited_launches": credited,
            "replay_device_ms": cuda_ms(g.graph.replay, iters=10, warmup=2),
            "prefill_captures": pre.captures,
            "prefill_replays": pre.replays,
            "prefill_pool_bytes": pre.pool_bytes(),
            "prefill_credited_launches": _by_function(pre.credited),
            "prefill_groups": sum(whole), "prefill_shapes": len(whole),
            "repeat_share": (1 - len(whole) / sum(whole) if whole else 0.0),
            "capture_at": graphs.CAPTURE_AT}


def _uncounted_replay_ms(eng: ContinuousEngine) -> float:
    """The finished engine's decode graph dropped and captured again
    outside every ``MoeCopies`` block, so without its counting kernels,
    and its device ms as ``graph_stats`` times it: beside that figure,
    what the counting costs a decode step."""
    eng.graph.drop()
    eng.graph.run()
    return cuda_ms(eng.graph.graph.replay, iters=10, warmup=2)


def _digest(handles) -> str:
    return hashlib.sha1(json.dumps([r.tokens for r in handles])
                        .encode()).hexdigest()


def _serve_paged(phase: str, params, cfg, prompts, budgets,
                 extras=None, scfg: ServeConfig = SERVE_PAGED,
                 mesh=None, warm: bool = True) -> dict:
    """The traffic once on the paged continuous engine (``SERVE_PAGED``),
    timed, after a warm-up that is not counted (the same prompts with 2
    new tokens each: it builds every prefill shape's flash schedule and
    warms cuBLAS and the allocator; ``warm=False`` skips it, for a run
    after another that warmed the same shapes).  Checks that every request emits its
    budget, that flash launched once per layer and whole-prompt prefill
    and the gather twice per layer and decode or chunk step (every other
    kernel never), that chunked prefill ran, that the timed run built
    nothing, and that no page leaked past the prefix cache's refs.  An
    MoE model's copies are counted (``MoeCopies``).  On one rank of a
    tensor-parallel ``mesh`` the kernels run at the rank's share of the
    heads, and every model dispatch must reduce its two seams a layer
    (``seams_per_dispatch``); ``tokens_sha1`` digests every request's
    tokens, for comparing ranks."""
    extras = extras or [None] * len(prompts)
    if warm:
        eng = ContinuousEngine(params, cfg, scfg, mesh=mesh)
        for p, e in zip(prompts, extras):
            eng.submit(p, 2, extra=e)
        eng.run(max_steps=10_000)
        del eng
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousEngine(params, cfg, scfg, mesh=mesh)
    tracer = obs.Tracer()
    moe = cfg.family == "moe"
    copies = MoeCopies() if moe else contextlib.nullcontext()
    compiles_before = _build.STATS.compiles
    reset_launches()
    tp_mod.seams = 0
    t0 = time.perf_counter()
    with obs.tracing(tracer), copies:
        handles = [eng.submit(p, b, extra=e)
                   for p, b, e in zip(prompts, budgets, extras)]
        eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = row_launches()

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
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{want}")
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
           "kernel_builds_in_timed_window": builds,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_graph": graph_stats(eng), "tokens_sha1": _digest(handles)}
    if moe:
        out.update(copies.report())
        if out["step_graph"] is not None:
            out["step_graph"]["replay_device_ms_uncounted"] = \
                _uncounted_replay_ms(eng)
    if mesh is not None:
        dispatches = n_prefill + s["chunk_steps"] + s["decode_steps"]
        if tp_mod.seams != 2 * cfg.n_layers * dispatches:
            raise AssertionError(f"{phase}: {tp_mod.seams} seam reductions "
                                 f"in {dispatches} dispatches of "
                                 f"{cfg.n_layers} layers")
        out.update(seams=tp_mod.seams,
                   seams_per_dispatch=tp_mod.seams / dispatches)
    return out


def phase_serve(params, cfg) -> dict:
    """The main path: qwen3-1.7b at full width, bf16, on the paged
    continuous engine with prefix sharing and chunked prefill."""
    out = _serve_paged("serve", params, cfg, *_serve_requests(cfg.vocab))
    if out["prefix_hits"] < 1:
        raise AssertionError("serve: no prefix hit: the path was not covered")
    emit("serve", **out)
    return out


#: the tensor-parallel phases' mesh widths: serve_tp's, differential_tp's
TP_SERVE, TP_DIFF = 2, (2, 4)
#: serve_tp's depth: qwen3-1.7b's full width at 4 of its 28 layers, so
#: the script keeps its time as its phases grow
TP_SERVE_LAYERS = 4
#: seconds a rank of a tensor-parallel phase may wait in one collective,
#: and the whole job may take
TP_TIMEOUT_S, TP_DEADLINE_S = 120.0, 400.0


def _tp_rank_setup(width: int):
    """A rank of a tensor-parallel phase: the card's settings of
    ``phase_device`` and a ``("model",)`` mesh of ``width`` ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.load_all()
    return mesh_for((width,), ("model",))


def _serve_tp_rank(rank: int) -> list[dict]:
    """One rank of ``serve_tp``: qwen3-1.7b at full width, cut to
    ``TP_SERVE_LAYERS`` layers (the same random weights on every rank,
    seed 0) on ``SERVE_PAGED`` over a 2-rank mesh (``_serve_paged`` with
    the mesh), with exact seams, then with int8-compressed ones (on the
    shapes the first run warmed)."""
    mesh = _tp_rank_setup(TP_SERVE)
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"),
                              n_layers=TP_SERVE_LAYERS)
    params = M.init_lm(cfg, seed=0, device=mesh.device)
    full_gb = sum(t.numel() * t.element_size()
                  for t in flatten(params).values()) / 1e9
    outs = []
    for compressed in (False, True):
        scfg = dataclasses.replace(SERVE_PAGED,
                                   compressed_collectives=compressed)
        out = _serve_paged("serve_tp_compressed" if compressed
                           else "serve_tp", params, cfg,
                           *_serve_requests(cfg.vocab), scfg=scfg,
                           mesh=mesh, warm=not compressed)
        out.update(rank=rank, backend=mesh.backend, device=str(mesh.device),
                   full_params_gb=full_gb)
        outs.append(out)
    return outs


def phase_serve_tp() -> dict:
    """qwen3-1.7b at full width (``TP_SERVE_LAYERS`` layers) served
    tensor-parallel over a 1-D mesh of 2 ranks, both on this one card and
    talking over gloo (NCCL refuses two ranks on one GPU): each rank holds 8 of the 16 heads, 4 of the 8 kv
    heads and half of d_ff, runs the bf16 causal flash kernel at (B, 8, 4,
    S, 128) and the gather over its 4-kv-head store, and all-reduces two
    seams a layer; then the same with int8-compressed seams
    (``serve_tp_compressed``).  Every rank must serve every request its
    budget, launch both kernels, and emit the same tokens as the other.
    Its times say nothing of tensor parallelism across cards: two
    processes share one card and every seam crosses the host.  Returns
    ``serve_tp``'s line."""
    ranks = spawn.run(_serve_tp_rank, TP_SERVE, device="cuda",
                      timeout_s=TP_TIMEOUT_S, deadline_s=TP_DEADLINE_S)
    lines = []
    for i, phase in enumerate(("serve_tp", "serve_tp_compressed")):
        outs = [r[i] for r in ranks]
        if len({o["tokens_sha1"] for o in outs}) != 1:
            raise AssertionError(f"{phase}: the ranks emitted different "
                                 f"tokens")
        for o in outs:
            if o["launches"]["flash_attention_causal"] < 1 \
                    or o["launches"]["paged_gather"] < 1:
                raise AssertionError(f"{phase}: rank {o['rank']} launches "
                                     f"{o['launches']}")
        lead = outs[0]
        out = {**{k: v for k, v in lead.items() if k not in (
                   "rank", "peak_mem_gb", "launches", "device")},
               "mesh": [TP_SERVE], "compressed_collectives": i == 1,
               "compress_block": SERVE_PAGED.compress_block,
               "rank_launches": [o["launches"] for o in outs],
               "rank_peak_mem_gb": [o["peak_mem_gb"] for o in outs],
               "rank_devices": [o["device"] for o in outs],
               "launches": lead["launches"],
               "reduced": {"n_layers": f"{TP_SERVE_LAYERS} of 28"},
               "note": "2 ranks share 1 card over gloo: not multi-GPU TP"}
        emit(phase, **out)
        lines.append(out)
    return lines[0]


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


#: the depth the serve and profile phases of the three deepest secondary
#: paths run at (the encoder-decoder's: encoder and decoder layers each),
#: cut to keep the script inside its time limit; zamba2's keeps the
#: pattern of 6-block groups and 3 trailing blocks
SERVE_DEPTH = {"zamba2-7b": 27, "llava-next-34b": 20,
               "seamless-m4t-large-v2": 8}


def phase_serve_vlm(params, cfg, full) -> dict:
    """The VLM path: llava-next-34b at full width, cut to ``cfg.n_layers``
    of ``full``'s 60 layers, bf16, on the paged engine, every prompt
    precomputed embeddings (seed 0): no prefix hit, though the 17th
    request shares the first's token ids."""
    prompts, budgets = _serve_requests(cfg.vocab)
    out = _serve_paged("serve_vlm", params, cfg, prompts, budgets,
                       _vlm_embeds(prompts, cfg.d_model, 0))
    if out["prefix_hits"] != 0:
        raise AssertionError(f"serve_vlm: {out['prefix_hits']} prefix hits "
                             f"for embedding prompts")
    out["reduced"] = {"n_layers": f"{cfg.n_layers} of {full.n_layers}"}
    emit("serve_vlm", **out)
    return out


def _enc_contexts(n: int, cfg, seed: int) -> list[dict]:
    """One standard-normal (enc_len, d_model) float32 encoder context per
    request (the speech frontend is a stub, as in the reference)."""
    rng = np.random.default_rng(seed)
    return [{"enc_embeds": rng.standard_normal(
        (cfg.enc_len, cfg.d_model)).astype(np.float32)} for _ in range(n)]


def _encdec_requests(cfg):
    """17 decoder prompts uniform in 4-32 tokens, the first two of exactly
    8 (one grouped prefill), 32-64 new tokens each, and each request's own
    encoder context (seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 33, 17)
    lens[:2] = 8
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    budgets = [int(n) for n in rng.integers(32, 65, len(prompts))]
    return prompts, budgets, _enc_contexts(len(prompts), cfg, 0)


#: the encoder-decoder's contiguous engine: 8 slots of 128 positions (a
#: prompt of at most 32 and 64 new tokens), cross caches of 4,096 frames
SERVE_ENCDEC = ServeConfig(max_len=128, capacity=8)


def phase_serve_encdec(params, cfg, full) -> dict:
    """The encoder-decoder path: seamless-m4t-large-v2 at full width, cut
    to ``cfg``'s encoder and decoder layers of ``full``'s 24 + 24, bf16,
    on the contiguous engine: per prefill
    dispatch flash runs bidirectionally in each encoder layer (MHA, 4,096
    frames, D 64) and causally in each decoder layer over the prompt;
    decode's cross-attention reads each slot's 4,096 cross keys through
    the plain ``_sdpa``, as the reference's does."""
    prompts, budgets, extras = _encdec_requests(cfg)
    out = _serve_contiguous(
        "serve_encdec", params, cfg, SERVE_ENCDEC, prompts, budgets,
        {"flash_attention": cfg.enc_layers,
         "flash_attention_causal": cfg.dec_layers},
        {"flash_signatures": fa_ops.variant_name(False, None),
         "flash_causal_signatures": fa_ops.variant_name(True, None)},
        extras=extras)
    enc = {(sig["hq"], sig["hkv"], sig["sq"], sig["skv"], sig["d"],
            sig["dtype"]) for sig in out["flash_signatures"]}
    if enc != {(cfg.n_heads, cfg.n_kv_heads, cfg.enc_len, cfg.enc_len,
                cfg.hd, "bfloat16")} or max(out["prefill_batches"]) < 2:
        raise AssertionError(f"serve_encdec: encoder signatures {enc}, "
                             f"prefill batches {out['prefill_batches']}")
    # the cross K/V every decode step reads: k and v, bf16, in each slot
    cross_bytes = 2 * cfg.dec_layers * SERVE_ENCDEC.capacity * cfg.enc_len \
        * cfg.n_kv_heads * cfg.hd * 2
    out.update(enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
               enc_len=cfg.enc_len, cross_cache_gb=cross_bytes / 1e9,
               reduced={"enc_layers": f"{cfg.enc_layers} of "
                                      f"{full.enc_layers}",
                        "dec_layers": f"{cfg.dec_layers} of "
                                      f"{full.dec_layers}"})
    emit("serve_encdec", **out)
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
    """:func:`profile_window`'s line."""
    out = profile_window(params, cfg, scfg)
    emit(phase, **out)
    return out


def profile_window(params, cfg, scfg: ServeConfig) -> dict:
    """Device time by kernel over a short serving window (8 requests of 100
    tokens, 16 new each; a VLM's prompts as embeddings, an
    encoder-decoder's requests each with its own context), from
    torch.profiler, whose CUPTI trace holds the kernels a replayed step
    graph runs as it holds eager launches."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 100).astype(np.int32)
               for _ in range(8)]
    if cfg.family == "enc_dec":
        extras = _enc_contexts(len(prompts), cfg, 1)
    elif cfg.input_mode == "embeddings":
        extras = _vlm_embeds(prompts, cfg.d_model, 1)
    else:
        extras = [None] * len(prompts)
    eng = ContinuousEngine(params, cfg, scfg, example_extra=extras[0])
    warm = ContinuousEngine(params, cfg, eng.scfg,   # builds, not profiled
                            example_extra=extras[0])
    warm.submit(prompts[0], 2, extra=extras[0])
    warm.run(max_steps=100)
    del warm
    for p, e in zip(prompts, extras):
        eng.submit(p, 16, extra=e)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
    stop_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    rows, host_ops = trace_totals(prof)
    totals_s = time.perf_counter() - t1
    busy_s = sum(r[0] for r in rows) / 1e6
    s = eng.stats
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "window": "8 x 100-token prompts, 16 new tokens, "
                     + ("paged" if scfg.paged else "contiguous"),
           "wall_s": wall, "setup_s": setup_s, "profiler_stop_s": stop_s,
           "trace_totals_s": totals_s,
           "device_busy_s": busy_s if rows else None,
           "device_idle_share": 1 - busy_s / wall if rows else None,
           "decode_steps": s["decode_steps"],
           "kernel_launches": sum(r[1] for r in rows),
           "top_kernels": [{"name": k, "calls": c, "ms": us / 1e3}
                           for us, c, k in rows[:12]],
           "top_host_ops": [{"op": k, "calls": c, "self_cpu_ms": us / 1e3}
                            for us, c, k in host_ops[:12]],
           "step_graphs": scfg.step_graphs}
    return out


#: the turns ``serve_graphs`` runs each model's traffic in, in one process
GRAPH_TURNS = ("eager", "graph", "graph", "eager")


def _graph_turns(name: str, run, params, cfg, scfg: ServeConfig,
                 profile: dict) -> dict:
    """``run(step_graphs)``, one timed pass of a serve phase's traffic, in
    :data:`GRAPH_TURNS`: each way's decode step p50, TTFT p50 and p99,
    prefill seconds, wall and tokens/s by turn, the graph turns' captures,
    replays, pool bytes, credited launches and step device ms, the decode
    step's and the prefill and chunk steps' (:func:`graph_stats`), each
    way's decode idle share (1 - that device ms over the way's decode step
    p50); then the device's idle share each way over the
    profile window: ``profile`` (the graph way, the phase just run) and
    the same window under eager dispatch.  Raises unless every turn gave
    the same tokens."""
    runs = collections.defaultdict(list)
    for way in GRAPH_TURNS:
        runs[way].append(run(way == "graph"))
    digests = {r["tokens_sha1"] for rs in runs.values() for r in rs}
    if len(digests) != 1:
        raise AssertionError(f"serve_graphs: {name}: graph and eager turns "
                             f"gave different tokens ({sorted(digests)})")
    out = {way: {k: [r[k] for r in rs] for k in (
        "decode_step_p50_ms", "ttft_p50_ms", "ttft_p99_ms", "wall_s",
        "tokens_per_s", "decode_steps", "prefill_s")}
        for way, rs in runs.items()}
    out["graph"]["step_graph"] = [r["step_graph"] for r in runs["graph"]]
    # the step's device work is the same kernels either way: what a decode
    # step waits on besides it is the host's
    device_ms = np.median([g["replay_device_ms"]
                           for g in out["graph"]["step_graph"]])
    for way in ("eager", "graph"):
        out[way]["decode_idle_share"] = [
            1 - device_ms / ms for ms in out[way]["decode_step_p50_ms"]]
    eager = profile_window(params, cfg, dataclasses.replace(
        scfg, step_graphs=False))
    out["profile"] = {
        way: {k: p[k] for k in ("wall_s", "device_busy_s",
                                "device_idle_share", "kernel_launches",
                                "decode_steps")}
        for way, p in (("eager", eager), ("graph", profile))}
    out["tokens_equal"] = True
    return out


#: ``serve_graphs``' repeated-length measurement (:func:`_waves`): the
#: phase's first prompts' lengths, new tokens a request, and waves enough
#: that each shape runs eagerly, is captured and is replayed
WAVE_REQUESTS, WAVE_TOKENS = 8, 4
WAVES = graphs.CAPTURE_AT + 1


def _prefill_us(events) -> dict[tuple, list[float]]:
    """(group size, prompt length) -> the µs of each whole-prompt prefill
    span of that shape, in order (dispatch to sampled tokens on the
    host)."""
    out = collections.defaultdict(list)
    for e in events:
        if e["name"] == "serve.prefill":
            out[(e["args"]["batch"], e["args"]["prompt_len"])].append(
                e["dur"])
    return out


def _break_even(eager: dict, graph: dict) -> dict:
    """What a capture costs and a replay saves, per whole-prompt shape,
    from the waves' prefill spans: eager = the median of the eager
    engine's spans of the shape; capture = the captured engine's span at
    the ``CAPTURE_AT``-th sighting (the warm-up, which is the step, then
    the capture) less eager; saving = eager less the median of its later
    (replayed) spans; ``ratio`` = capture / saving, the replays a capture
    needs to pay for itself, and its median over the shapes."""
    k, rows = graphs.CAPTURE_AT, {}
    for shape, spans in graph.items():
        if len(spans) <= k or shape not in eager:
            continue
        e = float(np.median(eager[shape])) / 1e3
        capture = spans[k - 1] / 1e3 - e
        saving = e - float(np.median(spans[k:])) / 1e3
        rows[f"{shape[0]}x{shape[1]}"] = {
            "eager_ms": e, "capture_ms": capture, "saving_ms": saving,
            "ratio": capture / saving if saving > 0 else None}
    ratios = [r["ratio"] for r in rows.values() if r["ratio"] is not None]
    return {"shapes": rows, "median_ratio": (float(np.median(ratios))
                                             if ratios else None)}


def _waves(params, cfg, scfg: ServeConfig, lens) -> dict:
    """Prompts of lengths ``lens`` (fresh tokens each wave, so no prefix is
    shared), ``WAVE_TOKENS`` new tokens each, in ``WAVES`` waves through one
    engine, each wave after the last has drained, eager and captured: the
    same shapes a wave, so a whole-prompt prefill is eager up to wave
    ``CAPTURE_AT``, captured in it and replayed after.  A synthetic
    traffic, for the replay path's cost and the capture rule's break-even
    (:func:`_break_even`), not a claim about users' prompts.  By wave:
    TTFT p50 and p99, the engine's prefill seconds, wall; the captured
    engine's prefill captures, replays, pool bytes and credited launches.
    Raises unless each wave's tokens are equal both ways and the last
    captured wave replayed every whole-prompt prefill and chunk step it
    ran."""
    rng = np.random.default_rng(8)
    waves = [[rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
             for _ in range(WAVES)]
    out, digests = {}, collections.defaultdict(set)
    spans = {}
    for way in ("eager", "graph"):
        eng = ContinuousEngine(params, cfg, dataclasses.replace(
            scfg, step_graphs=way == "graph"))
        rows, events = [], []
        for w, prompts in enumerate(waves):
            before = (eng.stats["prefill_s"],
                      eng.prefill_graphs.replays if eng.prefill_graphs
                      else 0)
            tracer = obs.Tracer()
            t0 = time.perf_counter()
            with obs.tracing(tracer):
                handles = [eng.submit(p, WAVE_TOKENS) for p in prompts]
                eng.run(max_steps=10_000)
            torch.cuda.synchronize()
            ttft = [r.admitted_at - r.submitted_at for r in handles]
            events += tracer.events()
            n_prefill = sum(e["name"] in ("serve.prefill",
                                          "serve.prefill_chunk")
                            for e in tracer.events())
            rows.append({"ttft_p50_ms": _pct_ms(ttft, 50),
                         "ttft_p99_ms": _pct_ms(ttft, 99),
                         "prefill_s": eng.stats["prefill_s"] - before[0],
                         "wall_s": time.perf_counter() - t0})
            if eng.prefill_graphs is not None:
                rows[-1]["prefill_replays"] = (eng.prefill_graphs.replays
                                               - before[1])
                rows[-1]["prefill_dispatches"] = n_prefill
            digests[w].add(_digest(handles))
        out[way] = rows
        spans[way] = _prefill_us(events)
        if eng.prefill_graphs is not None:
            pre = eng.prefill_graphs
            out["graph_steps"] = {
                "prefill_captures": pre.captures,
                "prefill_replays": pre.replays,
                "prefill_pool_bytes": pre.pool_bytes(),
                "prefill_credited_launches": _by_function(pre.credited)}
    last = out["graph"][-1]
    if any(len(d) != 1 for d in digests.values()) \
            or last["prefill_replays"] != last["prefill_dispatches"]:
        raise AssertionError(f"serve_graphs: waves: tokens equal "
                             f"{[len(d) == 1 for d in digests.values()]}, "
                             f"last wave {last}")
    out["break_even"] = _break_even(spans["eager"], spans["graph"])
    out.update(requests=len(lens), new_tokens=WAVE_TOKENS, waves=WAVES,
               capture_at=graphs.CAPTURE_AT)
    return out


def serve_graphs_dense(params, cfg, profile: dict) -> dict:
    """qwen3-1.7b's half of ``serve_graphs``: the ``serve`` phase's paged
    engine and traffic, eager and captured (:func:`_graph_turns`); every
    graph turn must credit the gather launches and replay a chunk step;
    then :func:`_waves` of its first prompts' lengths."""
    prompts, budgets = _serve_requests(cfg.vocab)
    out = _graph_turns(cfg.name, lambda on: _serve_paged(
        "serve_graphs", params, cfg, prompts, budgets,
        scfg=dataclasses.replace(SERVE_PAGED, step_graphs=on), warm=False),
        params, cfg, SERVE_PAGED, profile)
    if any(g["credited_launches"].get(pg.FUNCTION, 0) < 1
           or g["prefill_replays"] < 1
           for g in out["graph"]["step_graph"]):
        raise AssertionError(f"serve_graphs: no gather launch credited or "
                             f"no chunk step replayed "
                             f"({out['graph']['step_graph']})")
    out["waves"] = _waves(params, cfg, SERVE_PAGED,
                          [len(p) for p in prompts[:WAVE_REQUESTS]])
    return out


SERVE_SSM = ServeConfig(max_len=512, capacity=8)


def serve_graphs_ssm(params, cfg, profile: dict) -> dict:
    """mamba2-2.7b's half of ``serve_graphs``: the ``serve_ssm`` phase's
    contiguous engine and traffic, eager and captured (its one-off prompt
    lengths leave every whole-prompt prefill eager); then :func:`_waves`
    of its first prompts' lengths, whose replays launch the SSD kernel."""
    prompts, budgets = _ssm_requests(cfg.vocab)
    out = _graph_turns(cfg.name, lambda on: _serve_contiguous(
        "serve_graphs", params, cfg,
        dataclasses.replace(SERVE_SSM, step_graphs=on), prompts, budgets,
        {sk.FUNCTION: cfg.n_layers}, {}, warm=False),
        params, cfg, SERVE_SSM, profile)
    out["waves"] = _waves(params, cfg, SERVE_SSM,
                          [len(p) for p in prompts[:WAVE_REQUESTS]])
    if out["waves"]["graph_steps"]["prefill_credited_launches"].get(
            sk.FUNCTION, 0) < 1:
        raise AssertionError(f"serve_graphs: waves: no SSD launch credited "
                             f"({out['waves']['graph_steps']})")
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
        rows = row_launches()
        stats[order]["launches"] = {
            name: rows[name] for name in ("flash_attention_causal_f32",
                                          "paged_gather")}
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
    if any(min(st["launches"].values()) < 1 for st in stats.values()):
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
                      names: dict[str, str], extras=None,
                      warm: bool = True) -> dict:
    """The traffic once on the contiguous continuous engine, timed, after a
    warm-up that is not counted (the same prompts with 2 new tokens each:
    it builds the schedule of every prefill shape and warms cuBLAS and the
    allocator).  Checks that every request emits its budget, that each
    kernel (flash by its kernels-line rows) launched ``per_prefill[name]``
    times per prefill dispatch (every other kernel 0 times) and that the
    timed run built nothing; ``names`` maps an output field to the
    registry name whose served signatures it lists.  ``extras`` gives each
    request its extra inputs (an encoder-decoder's context), the first
    the engine's ``example_extra``; ``warm=False`` skips the warm-up, for
    a run after another that warmed the same shapes."""
    extras = extras or [None] * len(prompts)
    if warm:
        eng = ContinuousEngine(params, cfg, scfg, example_extra=extras[0])
        for p, e in zip(prompts, extras):
            eng.submit(p, 2, extra=e)
        eng.run(max_steps=10_000)
        del eng
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousEngine(params, cfg, scfg, example_extra=extras[0])
    tracer = obs.Tracer()
    compiles_before = _build.STATS.compiles
    reset_launches()
    t0 = time.perf_counter()
    with obs.tracing(tracer), schedule_cache(ScheduleCache()) as store:
        handles = [eng.submit(p, b, extra=e)
                   for p, b, e in zip(prompts, budgets, extras)]
        eng.run(max_steps=10_000)
        served = {field: registry.get(name, store).served_signatures()
                  for field, name in names.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = row_launches()

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
    want = {name: per_prefill.get(name, 0) * n_prefill for name in launches}
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
            "prefill_dispatches": n_prefill,
            "prefill_batches": [e["args"]["batch"] for e in events
                                if e["name"] == "serve.prefill"],
            "decode_steps": s["decode_steps"],
            "prefill_compiles": s["prefill_compiles"], **served,
            "launches": launches,
            "kernel_builds_in_timed_window": builds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_graph": graph_stats(eng), "tokens_sha1": _digest(handles)}


def phase_serve_ssm(params, cfg) -> dict:
    """The SSM path: mamba2-2.7b at full width, bf16, on the contiguous
    continuous engine with per-slot conv and SSD states."""
    prompts, budgets = _ssm_requests(cfg.vocab)
    out = _serve_contiguous(
        "serve_ssm", params, cfg, SERVE_SSM,
        prompts, budgets, {sk.FUNCTION: cfg.n_layers},
        {"ssd_signatures": sk_ops.NAME})
    chunks = sorted({sig["q"] for sig in out["ssd_signatures"]})
    if 256 not in chunks:
        raise AssertionError(f"no prefill ran the q = 256 chunk: "
                             f"{out['ssd_signatures']}")
    emit("serve_ssm", **out)
    return out


def phase_serve_hybrid(params, cfg, full) -> dict:
    """The hybrid path: zamba2-7b at full width, cut to ``cfg.n_layers`` of
    ``full``'s 81 mamba blocks, bf16, on the contiguous engine: per prefill
    the SSD kernel in each mamba block and flash (D 112, MHA) in the shared
    block of each group that runs it."""
    n_on = sum(M.hybrid_flags(cfg))
    prompts, budgets = _ssm_requests(cfg.vocab)
    out = _serve_contiguous(
        "serve_hybrid", params, cfg, ServeConfig(max_len=512, capacity=8),
        prompts, budgets, {sk.FUNCTION: cfg.n_layers,
                           "flash_attention_causal": n_on},
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
    out["reduced"] = {"n_layers": f"{cfg.n_layers} of {full.n_layers}"}
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
        prompts, budgets, {"flash_attention_causal": cfg.n_layers},
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
    ``extras`` gives each request its extra inputs (a VLM's embeddings, an
    encoder-decoder's context), the first the engine's
    ``example_extra``."""
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
            eng = ContinuousEngine(params, cfg, scfg,
                                   example_extra=extras[0])
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
        stats[order]["launches"] = row_launches()
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


def phase_differential_encdec(sip_cache: str, workdir: Path) -> dict:
    """seamless at full width cut to 2 encoder and 2 decoder layers,
    float32, 4,096-frame contexts kept, each request its own, on the
    contiguous engine against Engine.generate (``_differential``) at the
    served signatures of both flash variants: bidirectional in the
    encoder at (B, 16, 16, 4096, 4096, 64), causal over the prompts.  The
    two 5-token prompts prefill as one group in fifo order: a slot that
    read another slot's cross K/V would change tokens."""
    full = configs.get("seamless-m4t-large-v2")
    cfg = dataclasses.replace(full, enc_layers=2, dec_layers=2, n_layers=4,
                              dtype="float32")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 23, 5, 12, 40)]
    out = _differential(
        "differential_encdec", cfg, prompts, [8, 12, 16, 10, 14],
        ServeConfig(max_len=64, capacity=3),
        (fa_ops.variant_name(False, None), fa_ops.variant_name(True, None)),
        sip_cache, workdir, extras=_enc_contexts(len(prompts), cfg, 13))
    enc = {(sig["b"], sig["hq"], sig["hkv"], sig["sq"], sig["skv"],
            sig["d"], sig["dtype"])
           for sig in out["served"][fa_ops.variant_name(False, None)]}
    if (2, 16, 16, 4096, 4096, 64, "float32") not in enc:
        raise AssertionError(f"differential_encdec: no grouped encoder "
                             f"prefill at batch 2: {enc}")
    out["reduced"] = {"enc_layers": f"{cfg.enc_layers} of "
                                    f"{full.enc_layers}",
                      "dec_layers": f"{cfg.dec_layers} of {full.dec_layers}"}
    emit("differential_encdec", **out)
    return out


def phase_differential_padded(sip_cache: str, workdir: Path) -> dict:
    """qwen3 at full width cut to 4 layers, float32, its 16 query heads
    padded to 24 (zeroed wq/wo slices), 8 kv heads: (a) the paged engine
    against Engine.generate (``_differential``, the ``differential_*``
    prompts) and the contiguous engine against it too; (b) prefill logits
    of the padded model against the same weights with the padded slices
    cut away, within 1e-4 (the reference's check, tests/
    test_perf_levers.py); (c) flash over the 16 real heads launched on
    the padded path, paged and contiguous, and the gather on the paged
    one."""
    full = configs.get("qwen3-1.7b")
    cfg = dataclasses.replace(full, n_layers=4, dtype="float32",
                              padded_heads=24, use_pallas=True)
    params = M.init_lm(cfg, seed=1, device="cuda")
    prompts, budgets = _diff_paged_prompts(cfg.vocab, 14)
    out = _differential("differential_padded", cfg, prompts, budgets,
                        DIFF_PAGED, SERVED, sip_cache, workdir,
                        params=params)
    ref = Engine(params, cfg, ServeConfig(max_len=DIFF_PAGED.max_len))
    want = [ref.generate(p[None], b)[0] for p, b in zip(prompts, budgets)]
    reset_launches()
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=DIFF_PAGED.max_len, capacity=DIFF_PAGED.capacity))
    uids = [eng.submit(p, b).uid for p, b in zip(prompts, budgets)]
    got = eng.run(max_steps=1000)
    for i, uid in enumerate(uids):
        if not np.array_equal(got[uid], want[i]):
            raise AssertionError(f"differential_padded (contiguous): "
                                 f"request {i} gave {got[uid].tolist()}, "
                                 f"Engine gave {want[i].tolist()}")
    contiguous = {"decode_steps": eng.stats["decode_steps"],
                  "launches": row_launches()}
    # (b) the same weights with the padded heads' slices cut away
    sliced = dataclasses.replace(cfg, padded_heads=0)
    attn = params["blocks"]["attn"]
    cut = {**params, "blocks": {**params["blocks"], "attn": {
        **attn, "wq": attn["wq"][:, :, :cfg.n_heads].contiguous(),
        "wo": attn["wo"][:, :cfg.n_heads].contiguous()}}}
    toks = torch.as_tensor(np.stack([prompts[0], prompts[2]]),
                           device="cuda")           # the two 23-token prompts
    lp, _ = M.prefill(params, {"tokens": toks}, cfg, max_len=64)
    ls, _ = M.prefill(cut, {"tokens": toks}, sliced, max_len=64)
    diff = (lp - ls).abs().max().item()
    sigs = out["served"][SERVED[0]]
    fifo = out["fifo"]["launches"]
    if diff > 1e-4 or fifo["flash_attention_causal_f32"] < 1 \
            or fifo["paged_gather"] < 1 \
            or contiguous["launches"]["flash_attention_causal_f32"] < 1 or {
                (sig["hq"], sig["hkv"]) for sig in sigs} != {(16, 8)}:
        raise AssertionError(f"differential_padded: logits differ by "
                             f"{diff}, launches {fifo} (contiguous "
                             f"{contiguous['launches']}), flash "
                             f"signatures {sigs}")
    out.update(padded_heads=cfg.padded_heads, n_heads=cfg.n_heads,
               contiguous=contiguous, token_identical_contiguous=True,
               sliced_prefill_max_abs_diff=diff, sliced_limit=1e-4,
               reduced={"n_layers": f"{cfg.n_layers} of {full.n_layers}"})
    emit("differential_padded", **out)
    return out


def _differential_tp_rank(rank: int, width: int, prompts, budgets) -> dict:
    """One rank of ``differential_tp``: qwen3 at full width cut to 4 layers,
    float32, seed 1, over a mesh of ``width`` ranks, on the paged
    (``DIFF_PAGED``) and the contiguous engine."""
    mesh = _tp_rank_setup(width)
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=4,
                              dtype="float32")
    params = M.init_lm(cfg, seed=1, device=mesh.device)
    out = {}
    for name, scfg in (("paged", DIFF_PAGED), ("contiguous", ServeConfig(
            max_len=DIFF_PAGED.max_len, capacity=DIFF_PAGED.capacity))):
        reset_launches()
        eng = ContinuousEngine(params, cfg, scfg, mesh=mesh)
        uids = [eng.submit(p, b).uid for p, b in zip(prompts, budgets)]
        got = eng.run(max_steps=1000)
        out[name] = {"tokens": [got[u].tolist() for u in uids],
                     "launches": row_launches(),
                     "kv_heads": int(eng.caches["k"].shape[-2])}
    return out


def phase_differential_tp() -> dict:
    """qwen3 at full width cut to 4 layers, float32, seed 1, served
    tensor-parallel over 2 and 4 ranks on this card (gloo), paged and
    contiguous: every rank's tokens equal single-request Engine.generate
    on one device, and every rank launched flash at its share of the
    heads (and the gather, paged)."""
    full = configs.get("qwen3-1.7b")
    cfg = dataclasses.replace(full, n_layers=4, dtype="float32")
    params = M.init_lm(cfg, seed=1, device="cuda")
    prompts, budgets = _diff_paged_prompts(cfg.vocab, 15)
    ref = Engine(params, cfg, ServeConfig(max_len=DIFF_PAGED.max_len))
    want = [ref.generate(p[None], b)[0].tolist()
            for p, b in zip(prompts, budgets)]
    del params, ref
    torch.cuda.empty_cache()
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(prompts), "backend": "gloo", "mesh": {}}
    for width in TP_DIFF:
        outs = spawn.run(_differential_tp_rank, width,
                         args=(width, prompts, budgets), device="cuda",
                         timeout_s=TP_TIMEOUT_S, deadline_s=TP_DEADLINE_S)
        for rank, o in enumerate(outs):
            for name, run in o.items():
                if run["tokens"] != want:
                    raise AssertionError(
                        f"differential_tp mesh {width} rank {rank} {name}: "
                        f"{run['tokens']}, Engine gave {want}")
                if run["launches"]["flash_attention_causal_f32"] < 1 or (
                        name == "paged"
                        and run["launches"]["paged_gather"] < 1) \
                        or run["kv_heads"] != cfg.n_kv_heads // width:
                    raise AssertionError(f"differential_tp mesh {width} "
                                         f"rank {rank} {name}: {run}")
        out["mesh"][width] = {name: {"launches": run["launches"],
                                     "kv_heads": run["kv_heads"]}
                              for name, run in outs[0].items()}
    out.update(token_identical=True,
               reduced={"n_layers": f"{cfg.n_layers} of {full.n_layers}"})
    emit("differential_tp", **out)
    return out


# ===================================================== serving on a mesh, 2
#: serve_gspmd: mamba2-2.7b at full width, cut to ``GSPMD_LAYERS`` of its
#: 64 layers so the script keeps its time, on the contiguous engine, the
#: first requests of ``_ssm_requests`` with their budgets cut (a dispatch
#: gathers the whole model, a layer at a time, over gloo)
GSPMD_SERVE = ServeConfig(max_len=512, capacity=4)
GSPMD_REQUESTS, GSPMD_NEW, GSPMD_LAYERS = 3, 2, 16
#: the same phase while the mixer's compute was replicated along "model"
#: (each layer gathered whole a dispatch), on this card model at 700 W:
#: decode step p50, from PERF.md section 5 (a printed constant, not this
#: run's measurement)
GSPMD_REPLICATED = {"decode_step_p50_ms": 2281.0, "source": "PERF.md 5"}


def _gspmd_cfg():
    return dataclasses.replace(configs.get("mamba2-2.7b"),
                               n_layers=GSPMD_LAYERS)


#: serve_gspmd_encdec: seamless-m4t-large-v2 at full width, cut to
#: serve_encdec's depth (``SERVE_DEPTH``), bf16, on the contiguous engine
#: with 4 slots: the first of ``_encdec_requests`` (two of 8 tokens, one
#: grouped prefill, and one other), each its own 4,096-frame context, with
#: these budgets
GSPMD_ENCDEC = ServeConfig(max_len=128, capacity=4)
GSPMD_ENCDEC_NEW = (2, 3, 4)


def _encdec_cut(layers: int):
    """seamless-m4t-large-v2 at full width, ``layers`` encoder and
    ``layers`` decoder layers of its 24 + 24."""
    return dataclasses.replace(configs.get("seamless-m4t-large-v2"),
                               enc_layers=layers, dec_layers=layers,
                               n_layers=2 * layers)


def _gspmd_encdec_requests(cfg):
    prompts, _, extras = _encdec_requests(cfg)
    n = len(GSPMD_ENCDEC_NEW)
    return prompts[:n], list(GSPMD_ENCDEC_NEW), extras[:n]


def _flash_heads(store: ScheduleCache) -> dict[str, list[int]]:
    """The query heads of the flash signatures served under ``store`` (a
    run's own: an engine resolves its schedules from the store active
    when it is built), by variant."""
    out = {}
    for causal in (True, False):
        name = fa_ops.ensure_registered(causal=causal, window=None)
        heads = sorted({sig["hq"] for sig in
                        registry.get(name, store).served_signatures()})
        if heads:
            out[name] = heads
    return out


#: the job that runs serve_gspmd, serve_gspmd_encdec, differential_gspmd
#: and autotune_tp: its ranks, and the seconds it may take in all
MESH_RANKS, MESH_DEADLINE_S = 2, 400.0
#: autotune_tp's requests (of ``_serve_requests``: 115, 80, 104 and 31
#: tokens, each a whole-prompt prefill at batch 1), their budget, and the
#: seconds the service may take to get a promotion served
AUTOTUNE_TP_REQUESTS, AUTOTUNE_TP_NEW, AUTOTUNE_TP_LIMIT_S = \
    (3, 8, 16, 5), 6, 150.0


def _gb(tree) -> float:
    return sum(t.numel() * t.element_size()
               for t in flatten(tree).values()) / 1e9


def _gspmd_requests(vocab: int):
    prompts, _ = _ssm_requests(vocab)
    return prompts[:GSPMD_REQUESTS], [GSPMD_NEW] * GSPMD_REQUESTS


def _timed_run(eng: ContinuousEngine, prompts, budgets,
               extras=None) -> dict:
    """The requests, submitted at once, through ``eng`` until it drains,
    traced: every request's tokens, the wall, decode step p50, the
    dispatches and the kernels' launches."""
    extras = extras or [None] * len(prompts)
    tracer = obs.Tracer()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.tracing(tracer):
        handles = [eng.submit(p, b, extra=e)
                   for p, b, e in zip(prompts, budgets, extras)]
        eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = tracer.events()
    decode_us = [e["dur"] for e in events if e["name"] == "serve.decode"]
    tokens = [list(r.tokens) for r in handles]
    return {"tokens": tokens, "wall_s": wall,
            "tokens_per_s": sum(map(len, tokens)) / wall,
            "decode_step_p50_ms": float(np.percentile(decode_us, 50)) / 1e3,
            "prefill_dispatches": sum(e["name"] == "serve.prefill"
                                      for e in events),
            "decode_steps": len(decode_us), "launches": row_launches()}


def gspmd_one_device() -> dict:
    """``serve_gspmd``'s requests through a one-device engine of its
    ``ServeConfig`` on this card (its model, seed 0, as each rank makes
    it): the tokens its ranks must give, bitwise, and the times beside
    theirs."""
    cfg = _gspmd_cfg()
    params = M.init_lm(cfg, seed=0, device="cuda")
    prompts, budgets = _gspmd_requests(cfg.vocab)
    out = _timed_run(ContinuousEngine(params, cfg, GSPMD_SERVE), prompts,
                     budgets)
    del params
    torch.cuda.empty_cache()
    return out


def _serve_gspmd_rank(mesh) -> dict:
    """``serve_gspmd`` on one rank: mamba2-2.7b at full width
    (``GSPMD_LAYERS`` layers), bf16, seed 0, on the contiguous engine over
    the mesh (``tp_mode`` auto: the GSPMD path), its blocks at rest, its
    peak, and the bytes a dispatch gathers."""
    cfg = _gspmd_cfg()
    params = M.init_lm(cfg, seed=0, device=mesh.device)
    full_gb = _gb(params)
    eng = ContinuousEngine(params, cfg, GSPMD_SERVE, mesh=mesh)
    del params          # the rank keeps only its blocks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = {"params_gb": _gb(eng.params), "caches_gb": _gb(eng.caches)}
    out = _timed_run(eng, *_gspmd_requests(cfg.vocab))
    dispatches = out["prefill_dispatches"] + out["decode_steps"]
    split = eng.layout.split
    out.update(tp_path=eng.tp_path, tp_reason=eng.tp_reason,
               full_params_gb=full_gb, resident_gb=resident,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               gathered_gb_per_dispatch=eng.layout.gathered_bytes / 1e9
               / dispatches,
               split_cut=sorted(split.cut) if split else [],
               ssd_served_heads=sorted({s["h"] for s in registry.get(
                   sk_ops.NAME).served_signatures()}))
    del eng
    torch.cuda.empty_cache()
    return out


#: how far a split rank's prefill logits may lie from one device's, as a
#: share of the largest |logit|: in bf16 2 ** -6, two to four units in the
#: last place at that magnitude (a split rounds its partial products and
#: its column blocks' products on their own), in float32 1e-5
ENCDEC_LOGIT_RTOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}


def _encdec_groups(prompts) -> list[list[int]]:
    """The requests a contiguous engine prefills together: those of one
    prompt length, in order of first arrival."""
    groups: dict[int, list[int]] = {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    return list(groups.values())


def _encdec_prefill_logits(cfg, mesh=None) -> dict[str, np.ndarray]:
    """The last-token logits of ``serve_gspmd_encdec``'s prefill groups
    (``steps.prefill_step``, the engine's kernels), by request, at its
    model in bf16 and in float32 (the same draws, seed 0), on one device
    or, given ``mesh``, on this rank of it under the serving split."""
    prompts, _, extras = _gspmd_encdec_requests(cfg)
    groups = _encdec_groups(prompts)
    order = np.argsort([i for g in groups for i in g])
    out = {}
    for dtype in ENCDEC_LOGIT_RTOL:
        dcfg = dataclasses.replace(cfg, dtype=dtype, use_pallas=True)
        dev = "cuda" if mesh is None else mesh.device
        params = M.init_lm(dcfg, seed=0, device=dev)
        layout = None
        if mesh is not None:
            layout = train_steps.serve_layout(dcfg, mesh, 1,
                                              GSPMD_ENCDEC.max_len)
            params = partition.local_tree(params, layout.params)
        rows = []
        for group in groups:
            batch = {"tokens": torch.tensor(
                np.stack([prompts[i] for i in group]), device=dev),
                "enc_embeds": torch.tensor(np.stack(
                    [extras[i]["enc_embeds"] for i in group]),
                    device=dev).to(getattr(torch, dtype))}
            logits, _ = train_steps.prefill_step(
                params, batch, cfg=dcfg, max_len=GSPMD_ENCDEC.max_len,
                mesh=mesh, layout=layout)
            rows.append(logits.float().cpu().numpy())
        out[dtype] = np.concatenate(rows)[order]
        del params
        torch.cuda.empty_cache()
    return out


def gspmd_encdec_one_device(params, cfg) -> dict:
    """``serve_gspmd_encdec``'s requests through a one-device engine of
    its ``ServeConfig`` on this card, on ``serve_encdec``'s model (the
    same config and seed as each rank's): the tokens its ranks must give,
    the times beside theirs, and its prefill groups' logits."""
    prompts, budgets, extras = _gspmd_encdec_requests(cfg)
    out = _timed_run(ContinuousEngine(params, cfg, GSPMD_ENCDEC,
                                      example_extra=extras[0]),
                     prompts, budgets, extras)
    torch.cuda.empty_cache()
    return {**out, "logits": _encdec_prefill_logits(cfg)}


def encdec_agreement(ranks: list[dict], one: dict) -> dict:
    """How ``serve_gspmd_encdec``'s ranks agree with one device.  Each
    rank's prefill logits, per dtype, within ``ENCDEC_LOGIT_RTOL`` of the
    largest |logit| of one device's; in float32 every row's argmax equal.
    In bf16 a request whose first token one device takes from a tie (its
    top two logits within that tolerance: either may come out of a split
    that rounds its sums in another order) is excused from token identity
    and reported with both engines' tokens and the float32 argmax; every
    other request's tokens must equal one device's, bitwise, and at least
    one request must be held so.  -> the report and what failed."""
    report, bad = {}, []
    for dtype, rtol in ENCDEC_LOGIT_RTOL.items():
        want = one["logits"][dtype]
        tol = float(rtol * np.abs(want).max())
        top2 = np.sort(want, axis=-1)[:, -2:]
        per_rank = []
        for r in ranks:
            got = r["logits"][dtype]
            diff = float(np.abs(got - want).max())
            same = (got.argmax(-1) == want.argmax(-1)).tolist()
            per_rank.append({"max_abs_diff": diff, "argmax_equal": same})
            if diff > tol or (dtype == "float32" and not all(same)):
                bad.append((dtype, diff, tol, same))
        report[dtype] = {"tolerance": tol, "ranks": per_rank,
                         "top2_margin": (top2[:, 1] - top2[:, 0]).tolist(),
                         "argmax_one_device": want.argmax(-1).tolist()}
    bf16 = report["bfloat16"]
    tied = [i for i, m in enumerate(bf16["top2_margin"])
            if m <= bf16["tolerance"]]
    held = [i for i in range(len(one["tokens"])) if i not in tied]
    for rank, r in enumerate(ranks):
        for i in held:
            if r["tokens"][i] != one["tokens"][i]:
                bad.append(("tokens", rank, i, r["tokens"][i],
                            one["tokens"][i]))
    if not held:
        bad.append(("no request held to one device's tokens", tied))
    return {"logits": report, "held_requests": held,
            "tied_first_token": [{
                "request": i, "top2_margin": bf16["top2_margin"][i],
                "one_device": one["tokens"][i], "split": ranks[0]["tokens"][i],
                "float32_argmax": report["float32"]["argmax_one_device"][i]}
                for i in tied],
            "token_identical": all(r["tokens"] == one["tokens"]
                                   for r in ranks), "bad": bad}


def _serve_gspmd_encdec_rank(mesh) -> dict:
    """``serve_gspmd_encdec`` on one rank: seamless at full width
    (``SERVE_DEPTH``'s layers), bf16, seed 0, on the contiguous engine
    over the mesh, its encoder, decoder and cross-attention and MLPs split
    by heads and hidden dim (``steps.model_split``): its blocks at rest,
    its peak, the bytes a dispatch gathers, its caches' kv heads and the
    heads of the flash signatures it served."""
    cfg = _encdec_cut(SERVE_DEPTH["seamless-m4t-large-v2"])
    prompts, budgets, extras = _gspmd_encdec_requests(cfg)
    params = M.init_lm(cfg, seed=0, device=mesh.device)
    full_gb = _gb(params)
    with schedule_cache(ScheduleCache()) as store:
        eng = ContinuousEngine(params, cfg, GSPMD_ENCDEC, mesh=mesh,
                               example_extra=extras[0])
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = {"params_gb": _gb(eng.params),
                    "caches_gb": _gb(eng.caches)}
        out = _timed_run(eng, prompts, budgets, extras)
    dispatches = out["prefill_dispatches"] + out["decode_steps"]
    split = eng.layout.split
    out.update(tp_path=eng.tp_path, tp_reason=eng.tp_reason,
               full_params_gb=full_gb, resident_gb=resident,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               gathered_gb_per_dispatch=eng.layout.gathered_bytes / 1e9
               / dispatches,
               split_cut=sorted(split.cut) if split else [],
               cache_kv_heads={k: eng.caches[k]["k"].shape[-2]
                               for k in ("self", "cross")},
               flash_heads=_flash_heads(store),
               enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers)
    del eng
    torch.cuda.empty_cache()
    return {**out, "logits": _encdec_prefill_logits(cfg, mesh)}


def _differential_gspmd_cases() -> list[dict]:
    """``differential_gspmd``'s configs at full width, float32, depth cut:
    zamba2 (one group of 6 with the shared block, one trailing block),
    seamless (2 + 2 layers, each request its own 4,096-frame context),
    qwen3 with 16 heads padded to 24 on the paged engine, and qwen3 forced
    onto the GSPMD path on the paged engine (2 layers each); two requests
    of one length each (one prefill group), 3 new tokens; and the rows
    each config's path must launch."""
    paged = ServeConfig(max_len=128, capacity=2, paged=True, page_size=16,
                        prefill_chunk=64)
    qwen3 = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=2,
                                dtype="float32")
    seamless = dataclasses.replace(configs.get("seamless-m4t-large-v2"),
                                   enc_layers=2, dec_layers=2, n_layers=4,
                                   dtype="float32")
    cases = [
        ("zamba2", dataclasses.replace(configs.get("zamba2-7b"), n_layers=7,
                                       dtype="float32"),
         ServeConfig(max_len=128, capacity=2), 23,
         (sk.FUNCTION, "flash_attention_causal_f32")),
        ("seamless", seamless, ServeConfig(max_len=64, capacity=2), 5,
         ("flash_attention_f32", "flash_attention_causal_f32")),
        ("padded", dataclasses.replace(qwen3, padded_heads=24), paged, 23,
         ("flash_attention_causal_f32", "paged_gather")),
        ("qwen3_gspmd", qwen3, dataclasses.replace(paged, tp_mode="gspmd"),
         23, ("flash_attention_causal_f32", "paged_gather"))]
    out = []
    for i, (name, cfg, scfg, n, rows) in enumerate(cases):
        rng = np.random.default_rng(40 + i)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for _ in range(2)]
        extras = (_enc_contexts(2, cfg, 50 + i) if cfg.family == "enc_dec"
                  else [None, None])
        out.append({"name": name, "cfg": cfg, "scfg": scfg,
                    "prompts": prompts, "budgets": [3, 3], "extras": extras,
                    "rows": rows})
    return out


def _differential_gspmd_rank(mesh) -> dict:
    """``differential_gspmd`` on one rank: each case's requests through the
    engine over the mesh (seed 1's weights): tokens, path, launches."""
    out = {}
    for case in _differential_gspmd_cases():
        cfg = case["cfg"]
        params = M.init_lm(cfg, seed=1, device=mesh.device)
        with schedule_cache(ScheduleCache()) as store:
            eng = ContinuousEngine(params, cfg, case["scfg"], mesh=mesh,
                                   example_extra=case["extras"][0])
            del params
            run = _timed_run(eng, case["prompts"], case["budgets"],
                             case["extras"])
        split = eng.layout.split
        out[case["name"]] = {"tokens": run["tokens"],
                             "launches": run["launches"],
                             "tp_path": eng.tp_path,
                             "tp_reason": eng.tp_reason,
                             "split_cut": sorted(split.cut) if split else [],
                             "flash_heads": _flash_heads(store),
                             "gathered_gb": eng.layout.gathered_bytes / 1e9}
        del eng
        torch.cuda.empty_cache()
    return out


def _autotune_tp_rank(mesh) -> dict:
    """``autotune_tp`` on one rank: qwen3-1.7b at full width on
    ``SERVE_PAGED`` over the mesh (the manual path), as ``launch.serve
    --autotune --mesh`` runs it: the service on the first rank only,
    tuning what that rank dispatches (the engine's local config), its
    promotions staged and applied by every rank at a step boundary
    (``launch.serve.schedule_sync``).  A warm-up, a run without the
    service (recorded, so the service starts from its mix), then runs
    beside it until a promotion has swapped in and a promoted non-default
    schedule has served on the first rank (its call, broadcast)."""
    cfg = configs.get("qwen3-1.7b")
    params = M.init_lm(cfg, seed=0, device=mesh.device)
    every, _ = _serve_requests(cfg.vocab)
    prompts = [every[i] for i in AUTOTUNE_TP_REQUESTS]
    budgets = [AUTOTUNE_TP_NEW] * len(prompts)
    lead = mesh.rank == 0
    store = ScheduleCache()
    recorder = obs.WorkloadRecorder() if lead else None
    staging = Staging() if lead else None
    sync = serve_cli.schedule_sync(mesh, store, staging)

    def run(budgets, recorder=None):
        tracer = obs.Tracer()
        with schedule_cache(store), obs.tracing(tracer):
            eng = ContinuousEngine(params, cfg, SERVE_PAGED,
                                   recorder=recorder, mesh=mesh)
            handles = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
            while not eng.pool.idle:
                sync()
                eng.step()
        torch.cuda.current_stream().synchronize()
        swaps = [e["args"]["step"] for e in tracer.events()
                 if e["name"] == "serve.schedule_swap"]
        return eng, {"tokens": [list(r.tokens) for r in handles],
                     "schedule_swaps": eng.stats["schedule_swaps"],
                     "swap_steps": swaps}

    eng, _ = run([2] * len(prompts))
    svc = None
    if lead:
        svc = AutotuneService(
            store, source=recorder_source(recorder),
            target_for=serve_targets(eng.cfg, eng.scfg),
            config=AutotuneConfig(interval_s=1.0, budget=2, tune=LIVE_TUNE),
            log=EventLog(), device=mesh.device.type, staging=staging)
    local_heads = (eng.cfg.n_heads, eng.cfg.n_kv_heads)
    del eng
    baseline = run(budgets, recorder)[1]
    reset_launches()
    passes = []
    t0 = time.perf_counter()
    if svc is not None:
        svc.start()
    try:
        while True:
            passes.append(run(budgets, recorder)[1])
            done = None
            if svc is not None:
                served = _promoted_served(store, list(svc.log.events))
                done = bool(sum(p["schedule_swaps"] for p in passes)) and any(
                    r["serving_launches"] and not r["default"]
                    for r in served)
                if not done and time.perf_counter() - t0 \
                        > AUTOTUNE_TP_LIMIT_S:
                    raise AssertionError(
                        f"autotune_tp: no promoted non-default schedule "
                        f"served within {AUTOTUNE_TP_LIMIT_S} s: swaps "
                        f"{[p['schedule_swaps'] for p in passes]}, "
                        f"promotions {served}, service {svc.metrics()}")
            if mesh.broadcast_object(done):
                break
    finally:
        if svc is not None:
            svc.stop(timeout=None)
    with_service_s = time.perf_counter() - t0
    launches = row_launches()
    events = mesh.broadcast_object(
        [e for e in svc.log.events if e["kind"] in ("promoted", "error")]
        if svc is not None else None)
    out = {"baseline": baseline, "passes": passes,
           "promoted": _promoted_served(store, events),
           "errors": [e["error"] for e in events if e["kind"] == "error"],
           "local_heads": local_heads, "launches": launches,
           "with_service_s": with_service_s, "version": store.version}
    if svc is not None:
        out["service"] = svc.metrics()
    del params
    torch.cuda.empty_cache()
    return out


def _mesh_serve_rank(rank: int) -> dict:
    """One rank of the mesh serving job: ``serve_gspmd``,
    ``serve_gspmd_encdec``, ``differential_gspmd`` and ``autotune_tp`` in
    turn."""
    mesh = _tp_rank_setup(MESH_RANKS)
    out = {"serve_gspmd": _serve_gspmd_rank(mesh)}
    out["serve_gspmd_encdec"] = _serve_gspmd_encdec_rank(mesh)
    out["differential_gspmd"] = _differential_gspmd_rank(mesh)
    out["autotune_tp"] = _autotune_tp_rank(mesh)
    return {**out, "rank": rank, "device": str(mesh.device)}


def phase_mesh_serving(one_device: dict, encdec_one_device: dict) -> dict:
    """The configs the manual path cannot shard, served on a ``("model",)``
    mesh of 2 ranks through the GSPMD layout, and live autotuning beside
    a sharded engine: one job of 2 ranks sharing this card over gloo
    (NCCL refuses two ranks on one GPU), each phase its line.

    * ``serve_gspmd``: mamba2-2.7b at full width (``GSPMD_LAYERS``
      layers), bf16, contiguous, ``tp_mode`` auto.  Each rank keeps its ``SERVE_RULES`` blocks and
      gathers a layer at a time; it must take the GSPMD path, launch the
      SSD kernel once a layer and prefill dispatch, and give
      ``gspmd_one_device``'s tokens bitwise, as the other rank does.
      Resident GB at rest beside the whole model's, peak GB, GB gathered
      a dispatch, decode step p50 and tokens/s, a rank.
    * ``serve_gspmd_encdec``: seamless-m4t-large-v2 at full width
      (``SERVE_DEPTH``'s 8 + 8 layers), bf16, contiguous, ``tp_mode``
      auto, each request its own 4,096-frame context.  Its split must cut
      the attention (encoder, decoder, cross) and the MLPs; each rank
      launches bidirectional flash once an encoder layer and causal flash
      once a decoder layer a prefill, at its 8 of 16 heads only; its self
      and cross caches hold 8 kv heads; its prefill logits and tokens
      agree with ``gspmd_encdec_one_device``'s as ``encdec_agreement``
      holds them (bitwise tokens but where one device's first token is a
      bf16 tie).  The same figures as ``serve_gspmd``'s.
    * ``differential_gspmd``: ``_differential_gspmd_cases``, each token for
      token ``Engine.generate`` on one device (computed here, seed 1),
      each row of its path launched on both ranks; seamless's split as
      ``serve_gspmd_encdec``'s, its f32 flash at the rank's heads.
    * ``autotune_tp``: ``_autotune_tp_rank``; at least one promotion, the
      same swaps at the same steps on both ranks, the promoted non-default
      schedule launched on both after the swap, and every run's tokens
      equal on both ranks and to the run without the service.

    Two processes on one card, every gather through host memory: nothing
    here measures serving across cards.  Returns the ranks' results."""
    note = "2 ranks share 1 card over gloo: nothing of serving across cards"
    refs = {}
    for case in _differential_gspmd_cases():
        params = M.init_lm(case["cfg"], seed=1, device="cuda")
        ref = Engine(params, case["cfg"],
                     ServeConfig(max_len=case["scfg"].max_len))
        refs[case["name"]] = [ref.generate(p[None], b, extra_inputs=e and {
            k: v[None] for k, v in e.items()})[0].tolist()
            for p, b, e in zip(case["prompts"], case["budgets"],
                               case["extras"])]
        del params, ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn.run(_mesh_serve_rank, MESH_RANKS, device="cuda",
                      timeout_s=TP_TIMEOUT_S, deadline_s=MESH_DEADLINE_S)
    job_s = time.perf_counter() - t0

    sg = [r["serve_gspmd"] for r in ranks]
    n_layers = GSPMD_LAYERS
    local_heads = configs.get("mamba2-2.7b").ssm_heads // MESH_RANKS
    for o in sg:
        if o["tp_path"] != "gspmd" or o["tokens"] != one_device["tokens"] \
                or o["launches"][sk.FUNCTION] \
                < n_layers * o["prefill_dispatches"] \
                or o["split_cut"] != ["ssm"] \
                or o["ssd_served_heads"] != [local_heads]:
            raise AssertionError(
                f"serve_gspmd: path {o['tp_path']}, split "
                f"{o['split_cut']}, SSD heads {o['ssd_served_heads']}, "
                f"tokens {o['tokens']} (one device "
                f"{one_device['tokens']}), launches {o['launches']} in "
                f"{o['prefill_dispatches']} prefills")
    keep = ("tokens_per_s", "decode_step_p50_ms", "wall_s", "peak_mem_gb",
            "resident_gb", "gathered_gb_per_dispatch", "launches")
    emit("serve_gspmd", arch="mamba2-2.7b", dtype="bfloat16",
         n_layers=n_layers, requests=GSPMD_REQUESTS, new_tokens=GSPMD_NEW,
         capacity=GSPMD_SERVE.capacity, mesh=[MESH_RANKS],
         tp_path=sg[0]["tp_path"], tp_reason=sg[0]["tp_reason"],
         split_cut=sg[0]["split_cut"], ssd_heads_per_rank=local_heads,
         token_identical_to_one_device=True,
         full_params_gb=sg[0]["full_params_gb"],
         prefill_dispatches=sg[0]["prefill_dispatches"],
         decode_steps=sg[0]["decode_steps"],
         **{f"rank_{k}": [o[k] for o in sg] for k in keep},
         one_device={k: one_device[k] for k in (
             "tokens_per_s", "decode_step_p50_ms", "wall_s")},
         reduced={"n_layers": f"{GSPMD_LAYERS} of "
                              f"{configs.get('mamba2-2.7b').n_layers}"},
         replicated_before=GSPMD_REPLICATED, job_s=job_s, note=note)

    ed = [r["serve_gspmd_encdec"] for r in ranks]
    full = configs.get("seamless-m4t-large-v2")
    heads = full.n_heads // MESH_RANKS
    encdec_heads = {fa_ops.variant_name(c, None): [heads]
                    for c in (True, False)}
    agree = encdec_agreement(ed, encdec_one_device)
    for o in ed:
        want = {"flash_attention": o["enc_layers"] * o["prefill_dispatches"],
                "flash_attention_causal":
                    o["dec_layers"] * o["prefill_dispatches"]}
        if o["tp_path"] != "gspmd" or agree["bad"] \
                or o["split_cut"] != ["attn", "mlp"] \
                or o["flash_heads"] != encdec_heads \
                or o["cache_kv_heads"] != {"self": heads, "cross": heads} \
                or any(o["launches"][k] != v for k, v in want.items()):
            raise AssertionError(
                f"serve_gspmd_encdec: path {o['tp_path']}, split "
                f"{o['split_cut']}, flash heads {o['flash_heads']}, caches' "
                f"kv heads {o['cache_kv_heads']}, tokens {o['tokens']} (one "
                f"device {encdec_one_device['tokens']}), agreement "
                f"{agree['bad']}, launches {o['launches']} in "
                f"{o['prefill_dispatches']} prefills")
    emit("serve_gspmd_encdec", arch=full.name, dtype="bfloat16",
         enc_layers=ed[0]["enc_layers"], dec_layers=ed[0]["dec_layers"],
         enc_len=full.enc_len, requests=len(GSPMD_ENCDEC_NEW),
         new_tokens=list(GSPMD_ENCDEC_NEW),
         capacity=GSPMD_ENCDEC.capacity, mesh=[MESH_RANKS],
         tp_path=ed[0]["tp_path"], tp_reason=ed[0]["tp_reason"],
         split_cut=ed[0]["split_cut"], heads_per_rank=heads,
         flash_heads=ed[0]["flash_heads"],
         cache_kv_heads=ed[0]["cache_kv_heads"],
         token_identical_to_one_device=agree["token_identical"],
         rank_tokens=[o["tokens"] for o in ed],
         one_device_tokens=encdec_one_device["tokens"],
         held_requests=agree["held_requests"],
         tied_first_token=agree["tied_first_token"],
         prefill_logits=agree["logits"],
         full_params_gb=ed[0]["full_params_gb"],
         prefill_dispatches=ed[0]["prefill_dispatches"],
         decode_steps=ed[0]["decode_steps"],
         **{f"rank_{k}": [o[k] for o in ed] for k in keep},
         one_device={k: encdec_one_device[k] for k in (
             "tokens_per_s", "decode_step_p50_ms", "wall_s")},
         reduced={"enc_layers": f"{ed[0]['enc_layers']} of "
                                f"{full.enc_layers}",
                  "dec_layers": f"{ed[0]['dec_layers']} of "
                                f"{full.dec_layers}"},
         note=note)

    diff = [r["differential_gspmd"] for r in ranks]
    for case in _differential_gspmd_cases():
        name = case["name"]
        for rank, d in enumerate(diff):
            got = d[name]
            split_ok = name != "seamless" or (
                got["split_cut"] == ["attn", "mlp"]
                and got["flash_heads"] == encdec_heads)
            if got["tp_path"] != "gspmd" or got["tokens"] != refs[name] \
                    or any(got["launches"][row] < 1 for row in case["rows"]) \
                    or not split_ok:
                raise AssertionError(
                    f"differential_gspmd {name} rank {rank}: {got}, "
                    f"Engine gave {refs[name]}")
    emit("differential_gspmd", dtype="float32", mesh=[MESH_RANKS],
         token_identical=True,
         cases={c["name"]: {
             "arch": c["cfg"].name, "n_layers": c["cfg"].n_layers,
             "paged": c["scfg"].paged, "tp_mode": c["scfg"].tp_mode,
             "tp_reason": diff[0][c["name"]]["tp_reason"],
             "split_cut": diff[0][c["name"]]["split_cut"],
             "flash_heads": diff[0][c["name"]]["flash_heads"],
             "rows": list(c["rows"]),
             "rank_launches": [d[c["name"]]["launches"] for d in diff],
             "gathered_gb": diff[0][c["name"]]["gathered_gb"]}
             for c in _differential_gspmd_cases()}, note=note)

    at = [r["autotune_tp"] for r in ranks]
    lead = at[0]
    served = [[p for p in a["promoted"] if not p["default"]] for a in at]
    if lead["service"]["promotions"] < 1 or lead["errors"] \
            or not all(any(p["serving_launches"] for p in s)
                       for s in served) \
            or any([p["swap_steps"] for p in a["passes"]]
                   != [p["swap_steps"] for p in lead["passes"]]
                   or a["version"] != lead["version"] for a in at) \
            or not sum(p["schedule_swaps"] for p in lead["passes"]):
        raise AssertionError(f"autotune_tp: service {lead.get('service')}, "
                             f"errors {lead['errors']}, promoted "
                             f"{[a['promoted'] for a in at]}, swap steps "
                             f"{[[p['swap_steps'] for p in a['passes']] for a in at]}")
    for a in at:
        for i, p in enumerate(a["passes"]):
            if p["tokens"] != lead["baseline"]["tokens"] \
                    or a["baseline"]["tokens"] != lead["baseline"]["tokens"]:
                raise AssertionError(f"autotune_tp: run {i + 1} tokens "
                                     f"differ from the run without the "
                                     f"service, or across ranks")
    emit("autotune_tp", arch="qwen3-1.7b", dtype="bfloat16",
         mesh=[MESH_RANKS], tp_path="shard_map",
         local_heads=lead["local_heads"], requests=len(AUTOTUNE_TP_REQUESTS),
         token_identical=True, service=lead["service"],
         swaps_per_run=[p["schedule_swaps"] for p in lead["passes"]],
         swap_steps=[p["swap_steps"] for p in lead["passes"]],
         store_version=lead["version"],
         rank_promoted=[a["promoted"] for a in at],
         rank_launches=[a["launches"] for a in at],
         with_service_s=lead["with_service_s"], note=note)
    return {"serve_gspmd": sg, "serve_gspmd_encdec": ed,
            "differential_gspmd": diff, "autotune_tp": at}


# ================================================================ training
#: the train phase: the reference launcher's defaults (B8, S128)
TRAIN_DATA = dict(global_batch=8, seq_len=128)
TRAIN_STEPS = 8
#: train's steps with remat_policy "none" after the default's ("full")
TRAIN_NONE_STEPS = 4
#: the rows that a training step must not launch: the model's kernels,
#: whose plain versions carry the gradient (``use_pallas`` off)
MODEL_ROWS = tuple(FLASH_ROWS.values()) + (sk.FUNCTION,)


def _grad_report(grads) -> dict:
    """Raises unless every gradient leaf is finite and non-zero, a stacked
    block leaf in every layer; -> the number of leaves checked."""
    bad = []
    for key, g in flatten(grads).items():
        rows = g.flatten(1) if key.startswith("blocks/") else g.reshape(1, -1)
        peak = rows.abs().amax(dim=1)
        if not bool(torch.isfinite(g).all()) or not bool((peak > 0).all()):
            bad.append(key)
    if bad:
        raise AssertionError(f"train: gradients zero or non-finite at {bad}")
    return {"leaves": len(flatten(grads))}


def _profile_train_step(params, opt, batch, cfg, ocfg) -> dict:
    """One more step under torch.profiler, its loss + gradients and its
    AdamW update timed apart (synced): where a step's time goes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = train_steps.loss_and_grads(params, batch, cfg=cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw.adamw_update(grads, opt, params, ocfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rows, _ = trace_totals(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"loss_and_grads_ms": (t1 - t0) * 1e3,
            "adamw_update_ms": (t2 - t1) * 1e3, "wall_s": t2 - t0,
            "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / (t2 - t0),
            "kernel_launches": sum(r[1] for r in rows),
            "top_kernels": [{"name": k, "calls": c, "ms": us / 1e3}
                            for us, c, k in rows[:12]]}


def _train_steps(params, opt, cfg, dcfg, ocfg, first: int, n: int,
                 captured: bool) -> dict:
    """``n`` train steps on data steps ``first``.. over ``params`` and
    ``opt`` (updated in place): through one ``TrainGraph`` (the first
    warms up and captures, the rest replay) or eagerly.  Step times are
    synced; the allocator's cache is emptied and its peaks reset before
    the first step (a capture's warm-up runs on its own stream, which
    cannot reuse blocks cached for another: an earlier run's cache would
    add to its reserved peak)."""
    graph = (TrainGraph(params, opt, cfg=cfg, opt_cfg=ocfg,
                        device=torch.device("cuda")) if captured else None)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for step in range(first, first + n):
        batch = batch_for_model(cfg, dcfg, step, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if graph is not None:
            m = graph.step(batch)
        else:
            _, _, m = train_steps.train_step(params, opt, batch, cfg=cfg,
                                             opt_cfg=ocfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    out = {"losses": losses, "step_s": times,
           "step_p50_ms": float(np.median(times)) * 1e3,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    if graph is not None:
        out.update(captures=graph.captures, replays=graph.replays,
                   pool_bytes=graph.pool_bytes())
    return out


def phase_train(info: dict) -> dict:
    """The main path of training: qwen3-1.7b at full width, all 28 layers,
    bf16 compute over float32 master weights and moments, the config's
    remat (``"full"``: every layer runs again in the backward), 8 AdamW
    steps on data steps 0-7 (no checkpoint) through a captured
    ``TrainGraph`` (its first step warms up and captures, 7 replay), then
    the same 8 steps eagerly from the same seeded init, in one process:
    both p50s, both peaks (allocated and reserved), and the largest
    relative loss difference, which must be at most 1e-6.  Fails unless
    every loss is finite and the last is below the first, the first
    step's gradient of every leaf (of every layer) is finite and non-zero,
    and no flash or SSD kernel launched.  Tokens/s is B*S over the
    captured p50.  A ninth step (data step 8) runs eagerly under the
    profiler (``profiled_step``), a tenth is counted eagerly
    (``dryrun_vs_card``: a replay's ops pass no dispatch mode), then
    ``TRAIN_NONE_STEPS`` eager steps with ``remat_policy="none"`` and as
    many captured ones (``remat_none``)."""
    cfg = configs.get("qwen3-1.7b")
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1,
                           decay_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    params, opt = train_loop.make_train_state(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in adamw.leaves(params))
    reset_launches()
    _, grads = train_steps.loss_and_grads(
        params, batch_for_model(cfg, dcfg, 0, device="cuda"), cfg=cfg)
    seen = _grad_report(grads)
    del grads
    captured = _train_steps(params, opt, cfg, dcfg, ocfg, 0, TRAIN_STEPS,
                            captured=True)
    del params, opt
    torch.cuda.empty_cache()
    params, opt = train_loop.make_train_state(cfg, seed=0, device="cuda")
    eager = _train_steps(params, opt, cfg, dcfg, ocfg, 0, TRAIN_STEPS,
                         captured=False)
    losses = captured["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       eager["losses"]))
    launches = row_launches()
    profiled = _profile_train_step(
        params, opt, batch_for_model(cfg, dcfg, TRAIN_STEPS, device="cuda"),
        cfg, ocfg)
    batch = batch_for_model(cfg, dcfg, TRAIN_STEPS + 1, device="cuda")
    _, counted = _counted(lambda: train_steps.train_step(
        params, opt, batch, cfg=cfg, opt_cfg=ocfg), (params, opt, batch))
    none_cfg = dataclasses.replace(cfg, remat_policy="none")
    first = TRAIN_STEPS + 2
    none = {"eager": _train_steps(params, opt, none_cfg, dcfg, ocfg, first,
                                  TRAIN_NONE_STEPS, captured=False),
            "captured": _train_steps(params, opt, none_cfg, dcfg, ocfg,
                                     first + TRAIN_NONE_STEPS,
                                     TRAIN_NONE_STEPS, captured=True)}
    launches_none = row_launches()
    del params, opt
    torch.cuda.empty_cache()
    none_losses = [x for r in none.values() for x in r["losses"]]
    if not all(np.isfinite(losses + eager["losses"] + none_losses)) \
            or not losses[-1] < losses[0] or loss_rel > 1e-6 \
            or any(launches_none[r] for r in MODEL_ROWS):
        raise AssertionError(f"train: losses {losses}, eager "
                             f"{eager['losses']}, {none_losses}, launches "
                             f"{launches_none}")
    p50 = captured["step_p50_ms"]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "remat": cfg.remat, "remat_policy": cfg.remat_policy,
           "batch": dcfg.global_batch, "seq_len": dcfg.seq_len,
           "steps": TRAIN_STEPS, "losses": losses,
           "step_s": captured["step_s"], "step_p50_ms": p50,
           "tokens_per_s": dcfg.global_batch * dcfg.seq_len / p50 * 1e3,
           "max_memory_allocated_gb": captured["max_memory_allocated_gb"],
           "captured": captured, "eager": eager,
           "eager_over_captured_p50": eager["step_p50_ms"] / p50,
           "loss_max_rel_diff": loss_rel,
           "remat_none": {"steps": TRAIN_NONE_STEPS, **none,
                          "eager_over_captured_p50":
                              none["eager"]["step_p50_ms"]
                              / none["captured"]["step_p50_ms"]},
           "p50_full_over_none": p50 / none["captured"]["step_p50_ms"],
           "first_step_grads": seen, "launches": launches,
           "profiled_step": profiled, "nvidia_smi": info["nvidia_smi"]}
    emit("train", **out)
    return {**out, "counted_step": counted}


def _counted(fn, args, mesh=None):
    """``fn()`` counted by the dry run's ``StepCounter``, ``args`` its
    arguments (``dryrun_vs_card`` holds the dry run's prediction to it)
    -> (its result, {the counts, the bytes the allocator held as it
    began, its peak over the call (reset just before it), the kernels'
    launches in it})."""
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    box = {}
    counts = dryrun.count(lambda: box.update(out=fn()), args, mesh)
    torch.cuda.synchronize()
    return box["out"], {
        "counts": counts, "allocated_before": before,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": row_launches()}


def _train_on(device: str, cfg, params_cpu, n_steps: int) -> dict:
    """``n_steps`` float32 train steps of ``cfg`` on ``device`` from
    ``params_cpu``: the losses, the first step's gradients (on the CPU)
    and those of one forward + backward of the raw model (leaves that
    require grad, ``.backward()``, the logits' grad_fn checked).  On the
    card that forward with ``use_pallas`` set must raise: the kernels have
    no backward and refuse a call that autograd would record."""
    dcfg = DataConfig(global_batch=4, seq_len=64, vocab=cfg.vocab)
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=n_steps)
    params = M.map_params(lambda _, t: t.to(device), params_cpu)
    batch = batch_for_model(cfg, dcfg, 0, device=device)
    live = M.map_params(lambda _, t: t.clone().requires_grad_(), params)
    if device != "cpu":
        try:
            M.forward(live, batch, dataclasses.replace(cfg, use_pallas=True))
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{cfg.name}: a kernel ran under grad")
    logits, aux = M.forward(live, batch, cfg)
    if logits.grad_fn is None:
        raise AssertionError(f"{cfg.name} on {device}: forward under grad "
                             f"returned logits with no autograd node")
    torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), batch["labels"].long().flatten()) \
        .backward()
    backward = M.map_params(lambda _, t: t.grad.cpu(), live)
    del live, logits
    _, grads = train_steps.loss_and_grads(params, batch, cfg=cfg)
    grads = M.map_params(lambda _, t: t.cpu(), grads)
    opt = adamw.init_opt_state(params)
    losses = []
    for step in range(n_steps):
        params, opt, m = train_steps.train_step(
            params, opt, batch_for_model(cfg, dcfg, step, device=device),
            cfg=cfg, opt_cfg=ocfg)
        losses.append(m["loss"].item())
    return {"losses": losses, "grads": grads, "backward": backward}


def _max_rel_grad_err(got, want) -> float:
    """Largest |got - want| of any leaf over that leaf's largest |want|."""
    worst = 0.0
    want = flatten(want)
    for key, g in flatten(got).items():
        w = want[key]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    return worst


def phase_differential_train() -> dict:
    """qwen3-1.7b's and mamba2-2.7b's smoke configs, float32 (TF32 off):
    4 train steps on the card and on the CPU from the same weights and
    batches, the losses within rtol 1e-4 at every step and the first
    step's gradients within 1e-3 of each leaf's largest |g|; and one
    forward + backward through the model on the card with grad enabled
    (``use_pallas`` off: the plain flash and SSD) equal to the CPU's within
    the same bound, with no kernel launched, while the same forward with
    ``use_pallas`` set raises."""
    out = {}
    for arch in ("qwen3-1.7b", "mamba2-2.7b"):
        cfg = configs.get_smoke(arch)
        params = M.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        reset_launches()
        card = _train_on("cuda", cfg, params, 4)
        launches = row_launches()
        cpu = _train_on("cpu", cfg, params, 4)
        rel = {k: _max_rel_grad_err(card[k], cpu[k])
               for k in ("grads", "backward")}
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(card["losses"], cpu["losses"]))
        if loss_rel > 1e-4 or max(rel.values()) > 1e-3 \
                or any(launches[r] for r in MODEL_ROWS):
            raise AssertionError(f"differential_train {arch}: losses "
                                 f"{card['losses']} vs {cpu['losses']}, "
                                 f"gradient errors {rel}, launches "
                                 f"{launches}")
        out[arch] = {"losses_card": card["losses"],
                     "losses_cpu": cpu["losses"],
                     "loss_max_rel_err": loss_rel,
                     "first_step_grad_max_rel_err": rel["grads"],
                     "forward_backward_grad_max_rel_err": rel["backward"],
                     "launches": launches}
    out.update(loss_rtol=1e-4, grad_tol="1e-3 of each leaf's max |g|")
    emit("differential_train", **out)
    return out


def _train_resume_run(cfg, dcfg, ocfg, ckpt_dir: Path, steps: int,
                      every: int, chaos: ChaosEngine | None):
    """One supervised ``train`` run, traced: (result, its trace events)."""
    tcfg = train_loop.TrainConfig(total_steps=steps, ckpt_every=every,
                                  ckpt_dir=str(ckpt_dir), log_every=100,
                                  device="cuda")
    ft = FTManager(n_workers=1)
    sup = Supervisor(functools.partial(train_loop.train, cfg, dcfg, tcfg,
                                       ocfg, ft=ft, chaos=chaos),
                     ft=ft, chaos=chaos, sleep=lambda s: None)
    with obs.tracing() as tracer, obs.metrics_scope():
        res = sup.run()
    return res, tracer.events()


def _ckpt_seconds(events) -> dict:
    """Each save's blocked seconds (``train.checkpoint`` spans) and each
    background write's seconds (``ckpt.write`` spans, on the writer)."""
    return {"blocked_s": [e["args"]["blocked_s"] for e in events
                          if e["name"] == "train.checkpoint"],
            "write_s": [e["dur"] / 1e6 for e in events
                        if e["name"] == "ckpt.write"]}


def phase_train_resume(workdir: Path) -> dict:
    """qwen3-1.7b at full width cut to 2 of 28 layers (723 M params, an
    8.7 GB checkpoint of float32 params and moments), bf16 compute, B8
    S128, 4 steps under ``torch.use_deterministic_algorithms``: run A
    straight through; run B under the Supervisor with the plan ``crash@3``
    and an async save every 2 steps, which must restore step 2 and finish.
    B's final loss, params and moments must equal A's bitwise.  The
    checkpoint directories lie under ``workdir`` and are removed.  Each
    save writes the whole 8.7 GB (3 saves and a restore in all), so the
    run is as short as a restore from a save before the crash allows."""
    full = configs.get("qwen3-1.7b")
    cfg = dataclasses.replace(full, n_layers=2)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    steps, every, plan = 4, 2, "crash@3"
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=steps)
    root = workdir / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    det, fill = (torch.are_deterministic_algorithms_enabled(),
                 torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    # nothing here reads memory before writing it, and filling the pinned
    # snapshot buffers with NaN would add to the async save's blocked time
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        t0 = time.perf_counter()
        a, a_events = _train_resume_run(cfg, dcfg, ocfg, root / "a", steps,
                                        100, None)
        shutil.rmtree(root / "a")
        t1 = time.perf_counter()
        crash = ChaosEngine(FaultPlan.parse(plan))
        b, b_events = _train_resume_run(cfg, dcfg, ocfg, root / "b", steps,
                                        every, crash)
        run_s = [t1 - t0, time.perf_counter() - t1]
    finally:
        torch.use_deterministic_algorithms(det)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(root, ignore_errors=True)
    sup = b["supervisor"]
    kinds = [e["kind"] for e in sup["events"]]
    state_a = {"params": a["params"], "opt": a["opt_state"]}
    state_b = {"params": b["params"], "opt": b["opt_state"]}
    flat_b = flatten(state_b)
    differ = [k for k, x in flatten(state_a).items()
              if not torch.equal(x, flat_b[k])]
    n_params = sum(t.numel() for t in adamw.leaves(a["params"]))
    if sup["attempts"] != 2 or kinds != ["restart"] \
            or len(b["history"]) != 2 or differ \
            or b["final_loss"] != a["final_loss"]:
        raise AssertionError(f"train_resume: attempts {sup['attempts']}, "
                             f"events {kinds}, steps after the restore "
                             f"{len(b['history'])}, final loss "
                             f"{b['final_loss']} vs {a['final_loss']}, "
                             f"leaves that differ {differ}")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "checkpoint_gb": sum(t.numel() * t.element_size() for t in
                                adamw.leaves(state_b)) / 1e9,
           "dtype": cfg.dtype, "steps": steps, "plan": plan,
           "ckpt_every": every, "deterministic_algorithms": True,
           "attempts": sup["attempts"], "events": kinds,
           "restored_step": steps - len(b["history"]),
           "final_loss": b["final_loss"], "bitwise_equal": True,
           "losses_a": [m["loss"] for m in a["history"]],
           "checkpoints_a": _ckpt_seconds(a_events),
           "checkpoints_b": _ckpt_seconds(b_events), "run_s": run_s,
           "reduced": {"n_layers": f"{cfg.n_layers} of {full.n_layers}"}}
    emit("train_resume", **out)
    return out


# ======================================================= sharded training
#: the sharded phases' job: 2 ranks sharing this card over gloo
SHARDED_RANKS = 2
#: train_sharded's steps on each mesh: one untimed (counted), then the
#: timed ones; one timed step on (2, 1), whose ~17-20 s are gloo's host
#: copies of the params and gradient
SHARDED_STEPS = {(SHARDED_RANKS, 1): 2, (1, SHARDED_RANKS): 3}
#: train_sharded's (2, 1) run: qwen3-1.7b at full width, cut to this many
#: of its 28 layers for the script's time on a slow host: each of its
#: steps is gloo's host copies of every float32 leaf, gathered and
#: reduce-scattered over "data" (~15-35 s a step at 28)
DATA_TRAIN_LAYERS = 7


def _data_train_cfg():
    return dataclasses.replace(configs.get("qwen3-1.7b"),
                               n_layers=DATA_TRAIN_LAYERS)


#: train_sharded's SSM run on (1, 2): mamba2-2.7b at full width, its depth
#: cut for the script's time, and its steps (one counted, one timed)
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS = 8, 2


#: train_sharded's enc-dec run on (1, 2): seamless-m4t-large-v2 at full
#: width, its encoder and decoder each cut to ENCDEC_TRAIN_LAYERS of 24
#: for the script's time and the card's memory (one device's step peaks at
#: ~47 GB by the dry run, a rank's at ~24: the plain attention's float32
#: scores over 4,096 frames), and its steps (one counted, one timed)
ENCDEC_TRAIN_LAYERS, ENCDEC_TRAIN_STEPS = 4, 2


def _ssm_train_cfg():
    return dataclasses.replace(configs.get("mamba2-2.7b"),
                               n_layers=SSM_TRAIN_LAYERS)
#: the elastic phase: steps, checkpoint cadence, the heartbeat clock's tick
#: (the lost worker times out 4 steps after it stops: step 7 of 8)
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_TICK = 8, 4, 0.3
#: seconds the sharded job may take in all
SHARDED_DEADLINE_S = 600.0
AXES = ("data", "model")


def _step_traffic(pshard, mesh) -> dict:
    """Bytes a rank moves over ``"data"`` in one sharded step of a masked
    batch in one microbatch, in split mode, result bytes as the counter
    counts them: the float32 blocks its all-gathers build (each leaf that
    ``"data"`` cuts, gathered over ``"data"`` only: the rank's block along
    ``"model"``), the gradient shards its reduce-scatters leave it (the
    same leaves), and what its all-reduces sum: the gradient of every
    other leaf, the batch's token count, the three metrics and the
    data-cut shards' sum of squares (float32 each).  None of it where
    ``"data"`` has one rank."""
    gathered = scattered = reduced = 0
    if train_steps.data_ways(mesh) > 1:
        for sh in adamw.leaves(pshard):
            local = math.prod(sh.local_shape) * 4
            if sh.cuts("data"):
                gathered += local * mesh.shape["data"]
                scattered += local
            else:
                reduced += local
        reduced += 4 * (1 + 3 + 1)
    return {"gathered_gb": gathered / 1e9, "scattered_gb": scattered / 1e9,
            "reduced_gb": reduced / 1e9, "gathered_bytes": gathered,
            "scattered_bytes": scattered, "reduced_bytes": reduced}


def _span_s(events, names) -> dict:
    """Each span's seconds, summed per name, per step."""
    out = {n: [] for n in names}
    for e in events:
        if e["name"] in out:
            out[e["name"]].append(e["dur"] / 1e6)
    return out


def _train_sharded_full(mesh, cfg=None, n_steps: int | None = None) -> dict:
    """``train_sharded`` on one rank: ``cfg`` (default qwen3-1.7b) at full
    width on ``mesh`` ((2, 1) or (1, 2)), ``train``'s data and optimizer,
    ``n_steps`` (default the mesh's ``SHARDED_STEPS``) sharded steps (the
    first untimed and counted), traced."""
    cfg = cfg or configs.get("qwen3-1.7b")
    n_steps = n_steps or SHARDED_STEPS[tuple(mesh.shape.values())]
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1,
                           decay_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = train_loop.make_train_state(cfg, mesh, seed=0)
    pshard = train_steps.param_shardings(cfg, mesh)
    local_gb = sum(t.numel() * t.element_size()
                   for t in adamw.leaves({"p": params, "o": opt})) / 1e9
    init_peak = torch.cuda.max_memory_allocated()
    reset_launches()
    losses, times, modes = [], [], []

    def step_fn():
        return train_steps.sharded_train_step(
            params, opt, batch, cfg=cfg, opt_cfg=ocfg, mesh=mesh,
            shardings=pshard)[2]
    with obs.tracing() as tracer:
        for step in range(n_steps):
            batch = batch_for_model(cfg, dcfg, step, device=mesh.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 0:           # untimed: counted for dryrun_vs_card
                m, counted = _counted(step_fn, (params, opt, batch), mesh)
                counted["param_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in adamw.leaves(params))
                launches0 = counted["launches"]
            else:
                m = step_fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            modes.append(m["mode"])
    launches = {k: v + launches0[k] for k, v in row_launches().items()}
    peak = max(init_peak, torch.cuda.max_memory_allocated())
    del params, opt
    torch.cuda.empty_cache()
    split = train_steps.model_split(cfg, mesh, pshard)
    return {"losses": losses, "step_s": times, "modes": modes,
            "launches": launches, "peak_mem_gb": peak / 1e9,
            "local_state_gb": local_gb, **_step_traffic(pshard, mesh),
            "seams_cut": sorted(split.cut) if split else [],
            "counted_step": counted,
            "spans_s": _span_s(tracer.events(), (
                "train.gather", "train.grads", "train.reduce",
                "train.adamw"))}


def _differential_sharded(mesh_shapes, dev: torch.device) -> dict:
    """``differential_train_sharded`` on one rank: qwen3's smoke config in
    float32, one sharded step on each mesh against the one-device step on
    this card from the same weights and batch; params and both moments."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"),
                              dtype="float32", param_dtype="float32")
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab=cfg.vocab)
    ocfg = adamw.OptConfig()
    start = M.init_lm(cfg, seed=0, device=dev, dtype=torch.float32)
    batch = batch_for_model(cfg, dcfg, 0, device=dev)
    one = M.map_params(lambda _, t: t.clone(), start)
    one_opt = adamw.init_opt_state(one)
    one, one_opt, m1 = train_steps.train_step(one, one_opt, batch, cfg=cfg,
                                              opt_cfg=ocfg)
    want = flatten({"params": one, "mu": one_opt["mu"],
                    "nu": one_opt["nu"]})
    out = {}
    for shape in mesh_shapes:
        mesh = mesh_for(shape, AXES)
        pshard = train_steps.param_shardings(cfg, mesh)
        params = partition.local_tree(
            M.map_params(lambda _, t: t.clone(), start), pshard)
        opt = adamw.init_opt_state(params)
        params, opt, m = train_steps.sharded_train_step(
            params, opt, batch, cfg=cfg, opt_cfg=ocfg, mesh=mesh,
            shardings=pshard)
        sh = {"params": pshard, "mu": pshard, "nu": pshard}
        got = {k: flatten(sh)[k].gather(v) for k, v in flatten(
            {"params": params, "mu": opt["mu"], "nu": opt["nu"]}).items()}
        out[str(list(shape))] = {
            "max_rel_err": _max_rel_grad_err(got, want), "mode": m["mode"],
            "loss": m["loss"].item(), "loss_one_device": m1["loss"].item()}
    return out


def _pipeline_full() -> dict:
    """``pipeline`` on one rank: qwen3-1.7b's first two decoder blocks at
    full width, float32, one a stage over a (2,) ("stage",) mesh, 4
    microbatches of one (128, 2048) row; forward and each block's gradient
    of mean(y ** 2) against the two blocks in sequence on this rank."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=2,
                              dtype="float32")
    mesh = mesh_for((SHARDED_RANKS,), ("stage",))
    dev = mesh.device
    blocks_p = M.init_lm(cfg, seed=2, device=dev,
                         dtype=torch.float32)["blocks"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4, 128, cfg.d_model), generator=gen, device=dev)

    def stage(p, h):
        return model_blocks.decoder_block(p, h, cfg, causal=True)[0]

    live = M.map_params(lambda _, t: t.clone().requires_grad_(), blocks_p)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        y = pipeline.pipeline_apply(stage, live, x, mesh=mesh, axis="stage",
                                    n_micro=4)
        torch.mean(y ** 2).backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = row_launches()

    def summed(_, t):           # each rank holds its own stage's gradient
        g = t.grad.clone()
        torch.distributed.all_reduce(g, group=mesh.group("stage"))
        return g
    got = flatten(M.map_params(summed, live))
    seq = M.map_params(lambda _, t: t.clone().requires_grad_(), blocks_p)
    with torch.enable_grad():
        h = x
        for lp in model_blocks.layer_views(seq):
            h = stage(lp, h)
        torch.mean(h ** 2).backward()
    want = flatten(M.map_params(lambda _, t: t.grad, seq))
    scale = h.abs().max().item()
    return {"forward_max_rel_err": (y - h).abs().max().item() / scale,
            "grad_max_rel_err": _max_rel_grad_err(got, want),
            "stage_s": pipe_s,
            "stages": SHARDED_RANKS, "n_micro": 4,
            "bubble_fraction": pipeline.bubble_fraction(SHARDED_RANKS, 4),
            "launches": launches, "stage": mesh.coord("stage")}


def _train_elastic(workdir: str) -> dict:
    """``train_elastic`` on one rank: qwen3's smoke config, float32, under
    the Supervisor on a (2, 1) mesh, 2 workers of a chip each, worker 1
    lost for good at step 4 (``kill@4:w1:perm``), the ladder ((2, 1), (1,
    1)); and the same run uninterrupted."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"),
                              dtype="float32", param_dtype="float32")
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab=cfg.vocab)
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2,
                           decay_steps=ELASTIC_STEPS)
    root = Path(workdir) / "train_elastic"

    def tcfg(name):
        return train_loop.TrainConfig(
            total_steps=ELASTIC_STEPS, ckpt_every=ELASTIC_EVERY,
            ckpt_dir=str(root / name), log_every=1000)
    base = train_loop.train(cfg, dcfg, tcfg("base"), ocfg,
                            mesh=mesh_for((SHARDED_RANKS, 1), AXES))
    ladder = (((SHARDED_RANKS, 1), AXES), ((1, 1), AXES))
    t = [0.0]
    ft = FTManager(n_workers=2, cfg=FTConfig(
        heartbeat_timeout_s=1.0, chips_per_worker=1, mesh_ladder=ladder),
        clock=lambda: t[0])
    beat = ft.heartbeat

    def ticking(w, lat):        # a clock that moves one tick a heartbeat
        t[0] += ELASTIC_TICK
        beat(w, lat)

    ft.heartbeat = ticking
    chaos = ChaosEngine(FaultPlan.parse("kill@4:w1:perm", n_workers=2))
    reset_launches()
    t0 = time.perf_counter()
    sup = Supervisor(
        functools.partial(train_loop.train, cfg, dcfg, tcfg("chaos"), ocfg,
                          ft=ft, chaos=chaos),
        ft=ft, chaos=chaos, mesh=mesh_for((SHARDED_RANKS, 1), AXES),
        mesh_factory=lambda target: mesh_for(*target),
        sleep=lambda s: None)
    res = sup.run()
    s = res["supervisor"]
    return {"base_loss": base["final_loss"], "step": res["step"],
            "final_loss": res["final_loss"],
            "outside_mesh": bool(res.get("outside_mesh")),
            "events": [{k: v for k, v in e.items() if k != "attempt"}
                       for e in s["events"]],
            "final_mesh": list(s["final_mesh"][0]),
            "run_s": time.perf_counter() - t0, "launches": row_launches()}


def _sharded_rank(rank: int, workdir: str) -> dict:
    """One rank of the sharded job: its phases in turn (``train_elastic``
    last: the rank it leaves out waits for the job's end)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_for((SHARDED_RANKS, 1), AXES)
    out = {"train_sharded": _train_sharded_full(mesh, _data_train_cfg())}
    torch.cuda.empty_cache()
    model = mesh_for((1, SHARDED_RANKS), AXES)
    out["train_sharded_model"] = _train_sharded_full(model)
    torch.cuda.empty_cache()
    out["train_sharded_ssm"] = _train_sharded_full(
        model, _ssm_train_cfg(), SSM_TRAIN_STEPS)
    torch.cuda.empty_cache()
    out["train_sharded_encdec"] = _train_sharded_full(
        model, _encdec_cut(ENCDEC_TRAIN_LAYERS), ENCDEC_TRAIN_STEPS)
    torch.cuda.empty_cache()
    out["differential_train_sharded"] = _differential_sharded(
        ((SHARDED_RANKS, 1), (1, SHARDED_RANKS)), mesh.device)
    torch.cuda.empty_cache()
    out["pipeline"] = _pipeline_full()
    torch.cuda.empty_cache()
    out["train_elastic"] = _train_elastic(workdir)
    return out


def _one_device_losses(cfg, n_steps: int) -> list[float]:
    """A ``train_sharded`` run of ``cfg`` on this card alone: the same
    init (seed 0), data, optimizer and ``n_steps`` steps, one device."""
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1,
                           decay_steps=TRAIN_STEPS)
    params, opt = train_loop.make_train_state(cfg, seed=0)
    losses = []
    for step in range(n_steps):
        params, opt, m = train_steps.train_step(
            params, opt, batch_for_model(cfg, dcfg, step, device="cuda"),
            cfg=cfg, opt_cfg=ocfg)
        losses.append(m["loss"].item())
    del params, opt
    torch.cuda.empty_cache()
    return losses


def phase_train_sharded(workdir: Path, info: dict, train: dict) -> dict:
    """The sharded-training phases, one job of 2 ranks sharing this card
    over gloo (NCCL refuses two ranks on one GPU), each phase its line:

    * ``train_sharded``: qwen3-1.7b at full width, ``DATA_TRAIN_LAYERS``
      of its 28 layers, bf16 over float32 masters, remat "full",
      ``train``'s B8 S128 data, on a (2, 1) ("data", "model") mesh: each
      rank holds half of every embed dim of the params and moments,
      gathers the params whole for a step, runs its 4 rows and
      reduce-scatters the float32 gradient (all-reduces the leaves "data"
      does not cut).  Then all 28 layers on a (1, 2) mesh (``model``):
      each rank holds and runs its half of the heads, kv heads, MLP
      hidden dim and vocab (``steps.model_split``), all 8 rows,
      its seams all-reduces over "model".  Each: one untimed step
      (counted), then the timed ones: step p50, tokens/s, peak memory a
      rank, the bytes a step gathers, scatters and reduces over "data" and
      (the counter's) over "model", the loss mode, the spans.  Losses must
      be finite and equal on both ranks, the (2, 1) run's first within
      1e-2 of this card's one-device run of its cut, the (1, 2) run's (the
      same weights and batch as ``train``'s first step) of ``train``'s;
      the others are reported beside them.  Then on
      (1, 2) mamba2-2.7b (``SSM_TRAIN_LAYERS``; its mixers by heads) and
      seamless-m4t-large-v2 (``ENCDEC_TRAIN_LAYERS`` + as many: its
      encoder's, decoder's and cross-attention's heads, both MLPs and the
      decoder's vocab, its encoder over 4,096 frames), each loss within
      1e-2 of this card's one-device run from the same init, no
      all-gather over "model".
    * ``differential_train_sharded``: qwen3's smoke config in float32, one
      sharded step on (2, 1) and on (1, 2) against the one-device step on
      this card: max relative error under 2e-4 (the reference's bound).
    * ``pipeline``: qwen3's first two blocks at full width, float32, one a
      stage: forward and gradients against the blocks in sequence, 1e-4.
    * ``train_elastic``: the smoke config under the Supervisor, ladder
      ((2, 1), (1, 1)), ``kill@4:w1:perm``, 8 steps, a checkpoint every 4:
      step 8, one ``elastic_reshape``, final mesh [1, 1], the final loss
      within 5e-3 of the uninterrupted run's; rank 1 leaves the mesh.

    No kernel launches on these paths (the model runs its plain versions
    under grad).  Two processes on one card, every collective through host
    memory: nothing here measures training across cards."""
    note = "2 ranks share 1 card over gloo: not multi-GPU training"
    data_one = _one_device_losses(_data_train_cfg(),
                                  SHARDED_STEPS[SHARDED_RANKS, 1])
    ssm_one = _one_device_losses(_ssm_train_cfg(), SSM_TRAIN_STEPS)
    encdec_cfg = _encdec_cut(ENCDEC_TRAIN_LAYERS)
    encdec_one = _one_device_losses(encdec_cfg, ENCDEC_TRAIN_STEPS)
    # the ranks need ~29 GB each: hand back what this process's allocator
    # still holds from the earlier phases
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    ranks = spawn.run(_sharded_rank, SHARDED_RANKS, args=(str(workdir),),
                      device="cuda", timeout_s=TP_TIMEOUT_S,
                      deadline_s=SHARDED_DEADLINE_S)
    job_s = time.perf_counter() - t0
    shutil.rmtree(workdir / "train_elastic", ignore_errors=True)
    for r in ranks:
        for phase, res in r.items():
            if any(res.get("launches", {}).get(k) for k in MODEL_ROWS):
                raise AssertionError(f"{phase}: a kernel launched: "
                                     f"{res['launches']}")

    one = train["losses"][:max(SHARDED_STEPS.values())]
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    cfg = configs.get("qwen3-1.7b")

    def run_line(key, mesh, one=one):
        ts = [r[key] for r in ranks]
        losses = ts[0]["losses"]
        first_rel = abs(losses[0] - one[0]) / abs(one[0])
        if not all(np.isfinite(losses)) or first_rel > 1e-2 \
                or any(t["losses"] != losses for t in ts):
            raise AssertionError(f"train_sharded {mesh}: losses "
                                 f"{[t['losses'] for t in ts]}, one "
                                 f"device's {one}")
        p50 = float(np.median(ts[0]["step_s"][1:]))
        model = ts[0]["counted_step"]["counts"][
            "collective_bytes_by_axis"].get("model", {})
        return {"mesh": mesh, "steps": len(losses), "losses": losses,
                "first_loss_rel_diff": first_rel,
                "step_s": [t["step_s"] for t in ts],
                "step_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
                "rank_peak_mem_gb": [t["peak_mem_gb"] for t in ts],
                "local_state_gb": ts[0]["local_state_gb"],
                "gathered_gb_per_step": ts[0]["gathered_gb"],
                "scattered_gb_per_step": ts[0]["scattered_gb"],
                "reduced_gb_per_step": ts[0]["reduced_gb"],
                "model_axis_gb_per_step": {
                    op: v / 1e9 for op, v in model.items() if v},
                "seams_cut": ts[0]["seams_cut"],
                "loss_modes": sorted({m for t in ts for m in t["modes"]}),
                "spans_s_rank0": ts[0]["spans_s"],
                "launches": ts[0]["launches"]}

    data_line = run_line("train_sharded", [SHARDED_RANKS, 1], data_one)
    model_line = run_line("train_sharded_model", [1, SHARDED_RANKS])
    if model_line["seams_cut"] != ["attn", "mlp", "vocab"] \
            or model_line["model_axis_gb_per_step"].get("all-gather"):
        raise AssertionError(f"train_sharded (1, 2): {model_line}")
    ssm_line = run_line("train_sharded_ssm", [1, SHARDED_RANKS], ssm_one)
    ssm_rel = [abs(a - b) / abs(b)
               for a, b in zip(ssm_line["losses"], ssm_one)]
    if ssm_line["seams_cut"] != ["ssm", "vocab"] or max(ssm_rel) > 1e-2 \
            or ssm_line["model_axis_gb_per_step"].get("all-gather") \
            or not ssm_line["model_axis_gb_per_step"].get("all-to-all"):
        raise AssertionError(f"train_sharded mamba2 (1, 2): {ssm_line}, "
                             f"one device's losses {ssm_one}")
    ssm_line.update(arch="mamba2-2.7b", losses_one_device=ssm_one,
                    loss_rel_diff=ssm_rel,
                    reduced={"n_layers": f"{SSM_TRAIN_LAYERS} of "
                             f"{configs.get('mamba2-2.7b').n_layers}"})
    encdec_line = run_line("train_sharded_encdec", [1, SHARDED_RANKS],
                           encdec_one)
    encdec_rel = [abs(a - b) / abs(b)
                  for a, b in zip(encdec_line["losses"], encdec_one)]
    full = configs.get("seamless-m4t-large-v2")
    if encdec_line["seams_cut"] != ["attn", "mlp", "vocab"] \
            or max(encdec_rel) > 1e-2 \
            or encdec_line["model_axis_gb_per_step"].get("all-gather") \
            or not encdec_line["model_axis_gb_per_step"].get("all-reduce"):
        raise AssertionError(f"train_sharded seamless (1, 2): "
                             f"{encdec_line}, one device's losses "
                             f"{encdec_one}")
    encdec_line.update(arch=full.name, enc_len=full.enc_len,
                       losses_one_device=encdec_one,
                       loss_rel_diff=encdec_rel,
                       reduced={"enc_layers": f"{ENCDEC_TRAIN_LAYERS} of "
                                              f"{full.enc_layers}",
                                "dec_layers": f"{ENCDEC_TRAIN_LAYERS} of "
                                              f"{full.dec_layers}"})
    model_line.update(n_layers=cfg.n_layers, losses_one_device=one)
    out = {"arch": cfg.name, "n_layers": DATA_TRAIN_LAYERS,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "remat_policy": cfg.remat_policy, "axes": list(AXES),
           **TRAIN_DATA, **data_line, "losses_one_device": data_one,
           "reduced": {"n_layers": f"{DATA_TRAIN_LAYERS} of "
                                   f"{cfg.n_layers}"},
           "model": model_line, "ssm": ssm_line, "encdec": encdec_line,
           "job_s": job_s, "parent_reserved_gb": parent_gb,
           "nvidia_smi": info["nvidia_smi"], "note": note}
    emit("train_sharded", **out)

    diff = [r["differential_train_sharded"] for r in ranks]
    worst = max(v["max_rel_err"] for d in diff for v in d.values())
    if worst >= 2e-4:
        raise AssertionError(f"differential_train_sharded: {diff}")
    emit("differential_train_sharded", meshes=diff[0], max_rel_err=worst,
         limit=2e-4, dtype="float32", note=note)

    pipe = [r["pipeline"] for r in ranks]
    if any(p["forward_max_rel_err"] >= 1e-4 or p["grad_max_rel_err"] >= 1e-4
           for p in pipe) or sorted(p["stage"] for p in pipe) != [0, 1]:
        raise AssertionError(f"pipeline: {pipe}")
    emit("pipeline", **{k: v for k, v in pipe[0].items() if k != "stage"},
         rank_grad_max_rel_err=[p["grad_max_rel_err"] for p in pipe],
         limit=1e-4, note=note)

    counted = {key: [r[key]["counted_step"] for r in ranks]
               for key in ("train_sharded", "train_sharded_model",
                           "train_sharded_encdec")}
    el = [r["train_elastic"] for r in ranks]
    lead = el[0]
    rel = abs(lead["final_loss"] - lead["base_loss"]) / abs(lead["base_loss"])
    if lead["step"] != ELASTIC_STEPS or lead["final_mesh"] != [1, 1] \
            or [e["kind"] for e in lead["events"]] != ["elastic_reshape"] \
            or rel > 5e-3 or not el[1]["outside_mesh"] \
            or any(e["events"] != lead["events"] for e in el):
        raise AssertionError(f"train_elastic: {el}")
    emit("train_elastic", **{k: v for k, v in lead.items()
                             if k != "outside_mesh"},
         final_loss_rel_diff=rel, limit=5e-3,
         rank1_outside_mesh=el[1]["outside_mesh"], note=note)
    return {**out, "counted_steps": counted,
            "traffic": {key: {k: ranks[0][key][k] for k in (
                "gathered_bytes", "scattered_bytes", "reduced_bytes")}
                for key in counted}}


# ================================================================ dry run
#: the dryrun phase's cells (arch, shape, mesh): qwen3-1.7b's three kinds,
#: dbrx-132b's training, an SSM decode and the reference's slow cell on
#: the two-pod mesh
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
                ("qwen3-1.7b", "prefill_32k", "single"),
                ("qwen3-1.7b", "decode_32k", "single"),
                ("dbrx-132b", "train_4k", "single"),
                ("mamba2-2.7b", "decode_32k", "multi"),
                ("h2o-danube-1.8b", "long_500k", "multi"))
DRYRUN_TIMEOUT_S = 300.0
#: the card's memory (H100 SXM 80GB), what a cell's GB per device is held to
CARD_BYTES = 80e9
#: dryrun_vs_card: a predicted peak must be within this share of the
#: allocator's
PEAK_REL = 0.10
#: the CLI in a subprocess, then the kernels' launches in it
DRYRUN_CLI = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.gemm_fused import kernel as gf
from repro_torch.kernels.paged_attention import kernel as pg
from repro_torch.kernels.rmsnorm import kernel as rk
from repro_torch.kernels.ssd import kernel as sk
dryrun.main(sys.argv[1:])
print(json.dumps({"launches": sum(m.launches for m in (fa, gf, pg, rk, sk))}))
"""
#: dryrun_vs_card's configurations: train's (B8 S128) and a serving batch of
#: 8 prompts of 128 tokens, caches of 512
CARD_TRAIN = ShapeSpec("train_b8_s128", "train", TRAIN_DATA["seq_len"],
                       TRAIN_DATA["global_batch"])
CARD_PREFILL = ShapeSpec("prefill_b8_s128", "prefill", 128, 8)
CARD_DECODE = ShapeSpec("decode_b8_l512", "decode", 512, 8)
CARD_MAX_LEN = 512


def start_dryrun(workdir: Path) -> list:
    """The dryrun phase's cells, each through the CLI in a subprocess of
    its own, started at once (they need no card)."""
    out = workdir / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    root = Path(__file__).resolve().parent
    procs = []
    for i, (arch, shape, mesh) in enumerate(DRYRUN_CELLS):
        path = out / f"cell{i}.json"
        log = open(out / f"cell{i}.log", "w")
        procs.append((arch, shape, mesh, path, log, subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CLI, "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", str(path)], cwd=root,
            stdout=log, stderr=subprocess.STDOUT)))
    return procs


def predictions() -> dict:
    """The dry run's predictions of what the card runs in
    ``dryrun_vs_card``, each in a fake world of its own (this process
    joins no real one): (a) ``train``'s step on (1, 1), (b)
    ``train_sharded``'s on (2, 1) (``DATA_TRAIN_LAYERS`` layers) and on
    (1, 2), and its seamless run on (1, 2), (c) the serving batch's
    prefill and decode on (1, 1)."""
    cfg = configs.get("qwen3-1.7b")
    return {"train": dryrun.count_cell(cfg, CARD_TRAIN, (1, 1)),
            "train_sharded": dryrun.count_cell(_data_train_cfg(), CARD_TRAIN,
                                               (SHARDED_RANKS, 1)),
            "train_sharded_model": dryrun.count_cell(cfg, CARD_TRAIN,
                                                     (1, SHARDED_RANKS)),
            "train_sharded_encdec": dryrun.count_cell(
                _encdec_cut(ENCDEC_TRAIN_LAYERS), CARD_TRAIN,
                (1, SHARDED_RANKS)),
            "prefill": dryrun.count_cell(cfg, CARD_PREFILL, (1, 1),
                                         max_len=CARD_MAX_LEN),
            "decode": dryrun.count_cell(cfg, CARD_DECODE, (1, 1))}


def card_serve_steps() -> dict:
    """qwen3-1.7b at full width (bf16, seed 0) on this card, one device:
    ``prefill_step`` over 8 prompts of 128 tokens with caches of 512, then
    one ``serve_step``, each counted (``_counted``)."""
    cfg = configs.get("qwen3-1.7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (CARD_PREFILL.global_batch, CARD_PREFILL.seq_len),
        generator=gen, device="cuda", dtype=torch.int32)}
    (logits, caches), pre = _counted(lambda: train_steps.prefill_step(
        params, batch, cfg=cfg, max_len=CARD_MAX_LEN), (params, batch))
    tok = logits.argmax(-1).to(torch.int32)
    (logits2, _), dec = _counted(lambda: train_steps.serve_step(
        params, caches, tok, cfg=cfg), (params, caches, tok))
    out = {"prefill": pre, "decode": dec,
           "finite": bool(torch.isfinite(logits.float()).all()
                          and torch.isfinite(logits2.float()).all()),
           "tokens": [tok.tolist(), logits2.argmax(-1).tolist()]}
    del params, caches, logits, logits2
    torch.cuda.empty_cache()
    return out


def phase_dryrun(procs) -> dict:
    """``dryrun``: the CLI on ``DRYRUN_CELLS`` (fake worlds of 256 and 512
    ranks, fake tensors, no device).  Each cell must be ``ok`` on 256 or
    512 chips, count FLOPs, launch no kernel, and its depth probes'
    linear extrapolation must be its full-depth count within 1e-6;
    qwen3-1.7b's train_4k on one pod must fit the card's 80 GB.
    Beside each: GB per device against the card's 80 GB, the collective
    GB a device by axis, the dominant roofline term at the H100's rates
    and the seconds of the full-depth trace."""
    cells, bad = [], []
    for arch, shape, mesh, path, log, proc in procs:
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        text = (path.parent / (path.stem + ".log")).read_text()
        rec = (json.loads(path.read_text()).get(
            dryrun.cell_key(arch, shape, mesh), {}) if path.exists() else {})
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        launches = json.loads(lines[-1])["launches"] if lines else None
        cell = {"cell": dryrun.cell_key(arch, shape, mesh), "rc": rc,
                "status": rec.get("status"), "chips": rec.get("chips"),
                "fake_device": rec.get("fake_device"),
                "flops_per_device": rec.get("flops_per_device"),
                "probe_flops_rel_diff": rec.get("probe", {}).get(
                    "flops_rel_diff"),
                "gb_per_device": rec.get("memory_per_device_bytes", 0) / 1e9,
                "fits_80gb": rec.get("memory_per_device_bytes", 0)
                < CARD_BYTES,
                "param_gb_per_device": rec.get("param_bytes_per_device",
                                               0) / 1e9,
                "collective_gb_by_axis": {
                    a: v["total"] / 1e9 for a, v in
                    rec.get("collective_bytes_by_axis", {}).items()},
                "dominant": rec.get("roofline", {}).get("dominant"),
                "roofline_s": {k: v for k, v in
                               rec.get("roofline", {}).items()
                               if k != "dominant"},
                "trace_s": rec.get("trace_s"), "launches": launches}
        cells.append(cell)
        # qwen3-1.7b's one-pod train_4k must fit the card (remat and the
        # compute split along "model")
        must_fit = (arch, shape, mesh) == DRYRUN_CELLS[0]
        if must_fit and not cell["fits_80gb"]:
            bad.append((cell, "train_4k does not fit 80 GB"))
        if rc != 0 or cell["status"] != "ok" or cell["chips"] not in (
                256, 512) or not cell["flops_per_device"] or launches != 0 \
                or not cell["probe_flops_rel_diff"] <= 1e-6:
            bad.append((cell, text[-2000:]))
    if bad:
        raise AssertionError(f"dryrun: {bad}")
    out = {"cells": cells, "card_gb": CARD_BYTES / 1e9,
           "note": "counts of the port's program on fake tensors at H100 "
                   "SXM 80GB rates (700 W), not timings"}
    emit("dryrun", **out)
    return out


def _peak_miss(predicted: float, real: int) -> float:
    return abs(predicted - real) / real


def phase_dryrun_vs_card(got: dict, train: dict, sharded: dict,
                         card: dict) -> dict:
    """``dryrun_vs_card``: the dry run's predictions (``predictions``)
    against what this card ran, counted by the same ``StepCounter``:

    * (a) ``train``'s counted step (qwen3-1.7b full width, B8 S128, one
      device) against the cell on (1, 1);
    * (b) ``train_sharded``'s counted first step on each of its 2 ranks
      against the cell on (2, 1), and on (1, 2) (compute split along
      "model"; qwen3-1.7b, and seamless at ``ENCDEC_TRAIN_LAYERS`` + as
      many layers): besides, collective bytes by op and by axis and param
      bytes a rank equal, and those over "data" equal to
      ``_step_traffic``'s figures (all-gather, reduce-scatter, and the
      all-reduce at its weight 2);
    * (c) ``prefill_step`` then ``serve_step`` on one device
      (``card_serve_steps``) against the cells on (1, 1), finite logits.

    In each, FLOPs equal and the predicted peak within 10% of the
    allocator's over the step (the counter's own peak on the real run
    beside it); no kernel launches in any of them."""
    rows, bad = {}, []

    def row(name, pred, real):
        counts = real["counts"]
        r = {"predicted_flops": pred["flops"], "flops": counts["flops"],
             "predicted_peak_gb": pred["peak"] / 1e9,
             "max_memory_allocated_gb": real["max_memory_allocated"] / 1e9,
             "counter_peak_gb": counts["peak_bytes"] / 1e9,
             # what the allocator held outside the step's arguments when
             # it began (other phases' tensors, cuBLAS workspaces): the
             # counter cannot see it
             "held_outside_step_gb": (real["allocated_before"]
                                      - counts["held_bytes"]) / 1e9,
             "peak_miss": _peak_miss(pred["peak"],
                                     real["max_memory_allocated"]),
             "predicted_bytes": pred["bytes"], "bytes": counts["bytes"]}
        if pred["flops"] != counts["flops"]:
            bad.append((name, "flops", pred["flops"], counts["flops"]))
        if r["peak_miss"] > PEAK_REL:
            bad.append((name, "peak", r))
        rows[name] = r
        return r

    row("train", got["train"], train["counted_step"])
    for key, name in (("train_sharded", "train_sharded"),
                      ("train_sharded_model", "train_sharded_1x2"),
                      ("train_sharded_encdec", "train_sharded_encdec_1x2")):
        ts = got[key]
        traffic = sharded["traffic"][key]
        for rank, real in enumerate(sharded["counted_steps"][key]):
            r = row(f"{name}_rank{rank}", ts, real)
            counts = real["counts"]
            coll = {f"coll/{op}": v for op, v in
                    counts["collective_bytes"].items()}
            axes = {f"axis/{a}/{op}": counts["collective_bytes_by_axis"].get(
                a, {}).get(op, 0.0) for a in AXES
                for op in dryrun.COLLECTIVE_OPS}
            want = {k: v for k, v in ts.items()
                    if k.startswith(("coll/", "axis/"))}
            data = counts["collective_bytes_by_axis"].get("data", {})
            r.update(collectives_equal={**coll, **axes} == want,
                     param_bytes=real["param_bytes"],
                     predicted_param_bytes=ts["param_bytes"],
                     collective_bytes_by_axis=counts[
                         "collective_bytes_by_axis"],
                     step_traffic=traffic)
            if not r["collectives_equal"] or \
                    real["param_bytes"] != ts["param_bytes"] or \
                    data.get("all-gather", 0) != traffic["gathered_bytes"] \
                    or data.get("reduce-scatter", 0) \
                    != traffic["scattered_bytes"] or \
                    data.get("all-reduce", 0) != 2 * traffic["reduced_bytes"]:
                bad.append((f"{name}_rank{rank}", counts, ts, traffic))
    row("prefill", got["prefill"], card["prefill"])
    row("decode", got["decode"], card["decode"])
    launched = [real["launches"] for real in (
        card["prefill"], card["decode"], train["counted_step"],
        *(c for cs in sharded["counted_steps"].values() for c in cs))
        if any(real["launches"].values())]
    if launched or not card["finite"]:
        bad.append(("launches or non-finite logits", launched,
                    card["finite"]))
    if bad:
        raise AssertionError(f"dryrun_vs_card: {bad}")
    out = {"rows": rows, "peak_limit": PEAK_REL, "tokens": card["tokens"],
           "launches": 0,
           "note": "the dry run's counts against this card's run, the same "
                   "counter; train_sharded is 2 ranks sharing 1 card over "
                   "gloo"}
    emit("dryrun_vs_card", **out)
    return out


def kernels_line(gemm: dict, flash: dict, gather: dict, ssd: dict,
                 rms: dict, sip: dict, serve: dict, serve_ssm: dict,
                 serve_hybrid: dict, serve_swa: dict, serve_moe: dict,
                 serve_vlm: dict, serve_encdec: dict, train: dict,
                 serve_tp: dict, mesh: dict) -> dict:
    """One row per kernel, its launches from its own main path: the bf16
    causal flash kernel's from ``serve``, the float32 one's from ``sip``,
    the bidirectional one's from ``serve_encdec``; beside them each row's
    launches on the hybrid, sliding-window, MoE, VLM and encoder-decoder
    serve paths, on the training path (``train``: none, as the reference
    trains on its plain versions), on one rank of the tensor-parallel
    serve path (``serve_tp``, rank 0; the other rank's are equal), and on
    each rank of the mesh serving job (``phase_mesh_serving``):
    ``serve_gspmd``, ``serve_gspmd_encdec``, ``differential_gspmd`` (its
    cases summed) and ``autotune_tp`` (its runs beside the service)."""
    rows = []
    for mod, source, name, res, path in (
            (gf, gf.SOURCE, "gemm_fused_leaky_relu", gemm, sip),
            (fa, fa.SOURCE, "flash_attention_causal", flash, serve),
            (fa, fa.SOURCE_F32, "flash_attention_causal_f32", flash["f32"],
             sip),
            (fa, fa.SOURCE, "flash_attention", flash["bidirectional"],
             serve_encdec),
            (pg, pg.SOURCE, "paged_gather", gather, serve),
            (sk, sk.SOURCE, "ssd_intra_chunk", ssd, serve_ssm),
            (rk, rk.SOURCE, "rmsnorm_fused", rms, sip)):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": mod.REPLACES,
                     "launches": path["launches"][name],
                     "launches_hybrid": serve_hybrid["launches"][name],
                     "launches_swa": serve_swa["launches"][name],
                     "launches_moe": serve_moe["launches"][name],
                     "launches_vlm": serve_vlm["launches"][name],
                     "launches_encdec": serve_encdec["launches"][name],
                     "launches_train": train["launches"][name],
                     "launches_tp": serve_tp["launches"][name],
                     "launches_gspmd": [r["launches"][name]
                                        for r in mesh["serve_gspmd"]],
                     "launches_gspmd_encdec": [
                         r["launches"][name]
                         for r in mesh["serve_gspmd_encdec"]],
                     "launches_differential_gspmd": [
                         sum(c["launches"][name] for c in r.values())
                         for r in mesh["differential_gspmd"]],
                     "launches_autotune_tp": [r["launches"][name]
                                              for r in mesh["autotune_tp"]],
                     "max_abs_err": res["max_abs_err"],
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    # cuBLAS reads this once, at its first call: train_resume's
    # deterministic algorithms need it
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
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
    graph_turns = {cfg.name: serve_graphs_dense(
        params, cfg, phase_profile(params, cfg, SERVE_PAGED))}
    phase_autotune(params, cfg, workdir)
    del params
    torch.cuda.empty_cache()
    phase_differential(sip["cache"], workdir)
    serve_tp = phase_serve_tp()
    phase_differential_tp()
    cfg = configs.get("mamba2-2.7b")
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_ssm = phase_serve_ssm(params, cfg)
    gspmd_ref = gspmd_one_device()
    graph_turns[cfg.name] = serve_graphs_ssm(
        params, cfg, phase_profile(params, cfg, SERVE_SSM,
                                   phase="profile_ssm"))
    emit("serve_graphs", card=info["nvidia_smi"], **graph_turns)
    del params
    torch.cuda.empty_cache()
    phase_differential_ssm(sip["cache"], workdir)
    full = configs.get("zamba2-7b")
    cfg = dataclasses.replace(full, n_layers=SERVE_DEPTH[full.name])
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_hybrid = phase_serve_hybrid(params, cfg, full)
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
    full = configs.get("llava-next-34b")
    cfg = dataclasses.replace(full, n_layers=SERVE_DEPTH[full.name])
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_vlm = phase_serve_vlm(params, cfg, full)
    phase_profile(params, cfg, SERVE_PAGED, phase="profile_vlm")
    del params
    torch.cuda.empty_cache()
    phase_differential_vlm(sip["cache"], workdir)
    full = configs.get("seamless-m4t-large-v2")
    cfg = _encdec_cut(SERVE_DEPTH[full.name])
    params = M.init_lm(cfg, seed=0, device="cuda")
    serve_encdec = phase_serve_encdec(params, cfg, full)
    phase_profile(params, cfg, SERVE_ENCDEC, phase="profile_encdec")
    gspmd_encdec_ref = gspmd_encdec_one_device(params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_differential_encdec(sip["cache"], workdir)
    phase_differential_padded(sip["cache"], workdir)
    mesh = phase_mesh_serving(gspmd_ref, gspmd_encdec_ref)
    train = phase_train(info)
    phase_differential_train()
    phase_train_resume(workdir)
    sharded = phase_train_sharded(workdir, info, train)
    procs = start_dryrun(workdir)
    try:                        # the card's steps and the predictions run
        card = card_serve_steps()       # beside the CLI's cells
        preds = predictions()
        phase_dryrun(procs)
        phase_dryrun_vs_card(preds, train, sharded, card)
    finally:                    # a failed phase leaves no CLI running
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps(kernels_line(gemm, flash, gather, ssd, rms, sip, serve,
                                  serve_ssm, serve_hybrid, serve_swa,
                                  serve_moe, serve_vlm, serve_encdec, train,
                                  serve_tp, mesh)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
