"""Schedule-parameterized fused GEMM + LeakyReLU: the program and its kernel.

:func:`make_program` is the JAX package's instruction stream for one
(bm x bn) output tile (``repro/kernels/gemm_fused/kernel.py:35``), with two
faces per instruction: a torch ``fn`` (the CPU face, run by
``Program.execute`` over the grid, as Pallas interpret mode runs the
reference off-TPU) and a CUDA ``src`` snippet that ``Program.emit`` lays
out in schedule order inside ``csrc/gemm_fused.cu``.  The K dimension is
processed in ``bk`` steps, each with two MEM loads (an x tile and a w tile)
and one COMPUTE dot; SIP reorders the loads.

:class:`GemmKernel` is one schedule of the kernel: on CPU tensors it runs
the CPU face, on CUDA tensors it emits, builds (once per text) and launches
the CUDA kernel, counting ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.energy import UnassemblableSchedule
from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build, count_launch
from repro_torch.kernels._emit import (AsyncPlanner, buffer_decls, cfloat,
                                       divisor_at_most, emit_kernel,
                                       plan_shared)

ALPHA = 0.01
SOURCE = "src/repro_torch/csrc/gemm_fused.cu"
REPLACES = "src/repro/kernels/gemm_fused/kernel.py:89"
FUNCTION = "gemm_fused_leaky_relu"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}

launches = 0

_LOOP_I = "for (int i = 0; i < NACC; ++i) "


def make_program(*, m: int, n: int, k: int, bm: int, bn: int, bk: int,
                 dtype="float32") -> Program:
    """Build the instruction stream for one (bm x bn) output tile."""
    dtype = getattr(torch, dtype_name(dtype))
    esize = torch.empty((), dtype=dtype).element_size()
    k_steps = math.ceil(k / bk)
    instrs: list[Instr] = []

    def ld_x(env, s=0, bk=bk):
        return {f"x{s}": env["x_ref"][:, s * bk:(s + 1) * bk]}

    def ld_w(env, s=0, bk=bk):
        return {f"w{s}": env["w_ref"][s * bk:(s + 1) * bk, :]}

    def dot(env, s=0):
        part = env[f"x{s}"].float() @ env[f"w{s}"].float()
        return {f"acc{s + 1}": env[f"acc{s}"] + part}

    instrs.append(Instr(name="init_acc", kind=Kind.COMPUTE, inputs=(),
                        outputs=("acc0",),
                        fn=lambda env: {"acc0": torch.zeros((bm, bn))},
                        flops=0, src=_LOOP_I + "acc[i] = 0.f;"))
    for s in range(k_steps):
        instrs.append(Instr(name=f"ld_x{s}", kind=Kind.MEM, inputs=(),
                            outputs=(f"x{s}",), fn=functools.partial(ld_x, s=s),
                            buffer="x", bytes=bm * bk * esize,
                            src=f"load_x(x, X{s}, row0, {s * bk}); "
                                "cp_async_commit();"))
        instrs.append(Instr(name=f"ld_w{s}", kind=Kind.MEM, inputs=(),
                            outputs=(f"w{s}",), fn=functools.partial(ld_w, s=s),
                            buffer="w", bytes=bk * bn * esize,
                            src=f"load_w(w, W{s}, {s * bk}, col0, n); "
                                "cp_async_commit();"))
        instrs.append(Instr(name=f"dot{s}", kind=Kind.COMPUTE,
                            inputs=(f"x{s}", f"w{s}", f"acc{s}"),
                            outputs=(f"acc{s + 1}",),
                            fn=functools.partial(dot, s=s),
                            flops=2 * bm * bn * bk,
                            src=f"dot_tile(X{s}, W{s}, acc);"))
    acc_final = f"acc{k_steps}"

    def epilogue(env):
        y = env[acc_final]
        return {"y": torch.where(y >= 0, y, ALPHA * y).to(dtype)}

    instrs.append(Instr(name="leaky_relu", kind=Kind.COMPUTE,
                        inputs=(acc_final,), outputs=("y",), fn=epilogue,
                        flops=bm * bn,
                        src=_LOOP_I + "acc[i] = acc[i] >= 0.f ? acc[i] : "
                                      "ALPHA * acc[i];"))

    def store(env):
        env["o_ref"][...] = env["y"]
        return {}

    instrs.append(Instr(
        name="st_o", kind=Kind.MEM, inputs=("y",), outputs=(), fn=store,
        buffer="o", is_store=True, bytes=bm * bn * esize,
        src="store_o(o, acc, row0, col0, m, n);"))
    return Program(instrs, replications=(m // bm) * (n // bn))


def tile_layout(bm: int, bn: int, bk: int, dtype: str) -> dict:
    """The CUDA face's ``#define``s for a (bm, bn, bk) tile, with ``NT``
    threads, ``NACC`` accumulators a thread and the bytes of one X and one
    W buffer (``x_bytes``, ``w_bytes``).

    bf16 runs wgmma: one warpgroup per 64 rows and per 256 columns, rows
    zero-filled to a multiple of 64 and K to one of 16.  f32 runs 3xTF32 on
    mma.sync m16n8k8: up to 4 x 2 warps, each owning MT x NTL tiles of
    16 x 8, rows zero-filled to a multiple of 16.  Both copy 16 bytes at a
    time and take bn and bk in multiples of 8."""
    if dtype == "bfloat16":
        mp, kp = -(-bm // 64) * 64, -(-bk // 16) * 16
        wm, wn = mp // 64, -(-bn // 256)
        bnw = bn // wn
        return {"GEMM_WGMMA": 1, "MP": mp, "KP": kp, "WM": wm, "WN": wn,
                "BNW": bnw, "NACC": bnw // 2, "NT": 128 * wm * wn,
                "A_LBO": 128, "A_SBO": 16 * kp, "B_LBO": 16 * bn,
                "B_SBO": 128, "x_bytes": mp * kp * 2, "w_bytes": kp * bn * 2}
    mp = -(-bm // 16) * 16
    wr = divisor_at_most(mp // 16, 4)
    wc = divisor_at_most(bn // 8, 8 // wr)
    mt, ntl = mp // 16 // wr, bn // 8 // wc
    ldx, ldw = bk + 4, bn + 8
    return {"GEMM_WGMMA": 0, "MP": mp, "WR": wr, "WC": wc, "MT": mt,
            "NTL": ntl, "NACC": 4 * mt * ntl, "NT": 32 * wr * wc,
            "LDX": ldx, "LDW": ldw, "x_bytes": mp * ldx * 4,
            "w_bytes": bk * ldw * 4, "frag_regs": 8 * mt}


class GemmKernel:
    """One schedule (tiles and order) of the fused GEMM, both faces."""

    def __init__(self, *, m: int, n: int, k: int, bm: int, bn: int, bk: int,
                 dtype="float32", order: Sequence[int] | None = None):
        if m % bm or n % bn or k % bk:
            raise ValueError(f"tiles ({bm}, {bn}, {bk}) must divide "
                             f"({m}, {n}, {k})")
        self.k, self.bm, self.bn, self.bk = k, bm, bn, bk
        self.dtype = dtype_name(dtype)
        if self.dtype not in CTYPES:
            raise ValueError(f"gemm_fused: dtype {self.dtype} is not one of "
                             f"{list(CTYPES)}")
        self.program = make_program(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk,
                                    dtype=self.dtype)
        self.order = tuple(order) if order is not None \
            else self.program.default_order()
        if not self.program.is_legal(self.order):
            raise ValueError("illegal schedule order")
        self._text: tuple[str, int] | None = None
        self._kernels: dict[int, _build.Kernel] = {}
        #: this schedule's own launches (the module's ``launches`` counts
        #: every schedule's, from every thread)
        self.launches = 0

    # ------------------------------------------------------------ CUDA face
    @property
    def layout(self) -> dict:
        return tile_layout(self.bm, self.bn, self.bk, self.dtype)

    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes; raises ``UnassemblableSchedule`` when that exceeds a block or
        the accumulator does not fit the registers of its threads."""
        if self._text is None:
            if self.bn % 8 or self.bk % 8:
                raise UnassemblableSchedule(
                    f"{FUNCTION}: tiles ({self.bm}, {self.bn}, {self.bk}): "
                    f"bn and bk must be multiples of 8")
            lay = self.layout
            _build.check_regs(FUNCTION, lay["NT"], lay["NACC"]
                              + lay.get("frag_regs", 0))
            steps = self.k // self.bk
            buffer_of = {f"x{s}": f"X{s}" for s in range(steps)}
            buffer_of.update({f"w{s}": f"W{s}" for s in range(steps)})
            sizes = {f"X{s}": lay["x_bytes"] for s in range(steps)}
            sizes.update({f"W{s}": lay["w_bytes"] for s in range(steps)})
            plan = plan_shared(self.program, self.order, buffer_of, sizes)
            _build.check_smem(FUNCTION, plan.total)
            wgmma = frozenset(f"dot{s}" for s in range(steps)) \
                if lay["GEMM_WGMMA"] else frozenset()
            body = self.program.emit(self.order, before=AsyncPlanner(
                plan, buffer_of, proxy_readers=wgmma))
            defines = {"T": CTYPES[self.dtype], "BM": self.bm, "BN": self.bn,
                       "BK": self.bk, "KDIM": self.k, "ALPHA": cfloat(ALPHA),
                       **{k: v for k, v in lay.items()
                          if k.isupper()}}
            text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("gemm_fused.cu"), defines,
                buffer_decls(plan, {b: "T" for b in sizes}), body)
            self._text = (text, plan.total)
        return self._text

    def _launch(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        for name, t in (("x", x), ("w", w)):
            if t.device.type != "cuda" or t.device != x.device:
                raise ValueError(f"gemm_fused: {name} on {t.device}, x on "
                                 f"{x.device}; both must be on one CUDA "
                                 f"device")
            if dtype_name(t.dtype) != self.dtype or t.dim() != 2 \
                    or not t.is_contiguous():
                raise ValueError(f"gemm_fused: {name} must be a contiguous "
                                 f"2-D {self.dtype} tensor, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        m, k = x.shape
        n = w.shape[1]
        if k != self.k or w.shape[0] != k or m % self.bm or n % self.bn:
            raise ValueError(f"gemm_fused: x {tuple(x.shape)} w "
                             f"{tuple(w.shape)} do not fit this schedule "
                             f"(K {self.k}, tiles {self.bm} x {self.bn})")
        if (x.data_ptr() | w.data_ptr()) % 16:
            raise ValueError("gemm_fused: x and w must start on 16-byte "
                             "boundaries (the kernel copies 16 bytes at a "
                             "time)")
        dev = x.device.index if x.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            kern.launch((m // self.bm, n // self.bn, 1), self.layout["NT"],
                        [ctypes.c_void_p(x.data_ptr()),
                         ctypes.c_void_p(w.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()),
                         ctypes.c_int(m), ctypes.c_int(n)])
        count_launch(self)
        return out

    # ------------------------------------------------------------- CPU face
    def _execute(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        m, n = x.shape[0], w.shape[1]
        bm, bn = self.bm, self.bn
        out = torch.empty((m, n), dtype=x.dtype)
        for i in range(m // bm):
            for j in range(n // bn):
                self.program.execute(
                    {"x_ref": x[i * bm:(i + 1) * bm],
                     "w_ref": w[:, j * bn:(j + 1) * bn],
                     "o_ref": out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]},
                    self.order)
        return out

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu" and w.device.type == "cpu":
            return self._execute(x, w)
        return self._launch(x, w)
