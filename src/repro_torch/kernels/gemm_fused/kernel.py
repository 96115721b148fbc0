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

from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build
from repro_torch.kernels._emit import (SyncPlanner, buffer_decls, cfloat,
                                       divisor_at_most, emit_kernel,
                                       plan_shared)

ALPHA = 0.01
SOURCE = "src/repro_torch/csrc/gemm_fused.cu"
REPLACES = "src/repro/kernels/gemm_fused/kernel.py:89"
FUNCTION = "gemm_fused_leaky_relu"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}
MAX_THREADS = 256

launches = 0

_LOOP_IJ = "for (int i = 0; i < TM; ++i) for (int j = 0; j < TN; ++j) "


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
                        flops=0, src=_LOOP_IJ + "acc[i][j] = 0.f;"))
    for s in range(k_steps):
        instrs.append(Instr(name=f"ld_x{s}", kind=Kind.MEM, inputs=(),
                            outputs=(f"x{s}",), fn=functools.partial(ld_x, s=s),
                            buffer="x", bytes=bm * bk * esize,
                            src=f"load_x(x, X{s}, row0, {s * bk}, m);"))
        instrs.append(Instr(name=f"ld_w{s}", kind=Kind.MEM, inputs=(),
                            outputs=(f"w{s}",), fn=functools.partial(ld_w, s=s),
                            buffer="w", bytes=bk * bn * esize,
                            src=f"load_w(w, W{s}, {s * bk}, col0, n);"))
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
                        src=_LOOP_IJ + "acc[i][j] = acc[i][j] >= 0.f ? "
                                       "acc[i][j] : ALPHA * acc[i][j];"))

    def store(env):
        env["o_ref"][...] = env["y"]
        return {}

    instrs.append(Instr(
        name="st_o", kind=Kind.MEM, inputs=("y",), outputs=(), fn=store,
        buffer="o", is_store=True, bytes=bm * bn * esize,
        src=_LOOP_IJ + "{ const int r = row0 + ty + TR * i, "
                       "c = col0 + tx + TC * j; if (r < m && c < n) "
                       "o[(size_t)r * n + c] = from_f<T>(acc[i][j]); }"))
    return Program(instrs, replications=(m // bm) * (n // bn))


def thread_grid(bm: int, bn: int) -> tuple[int, int]:
    """(TR, TC): threads along the tile's rows and columns."""
    tc = divisor_at_most(bn, 16)
    return divisor_at_most(bm, max(MAX_THREADS // tc, 1)), tc


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

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes; raises ``UnassemblableSchedule`` when that exceeds a block."""
        if self._text is None:
            bm, bn, bk = self.bm, self.bn, self.bk
            esize = 4 if self.dtype == "float32" else 2
            pad = 4 // esize          # one 32-bit word per row: no conflicts
            ldx, ldw = bk + pad, bn + pad
            steps = self.k // bk
            buffer_of = {f"x{s}": f"X{s}" for s in range(steps)}
            buffer_of.update({f"w{s}": f"W{s}" for s in range(steps)})
            sizes = {f"X{s}": bm * ldx * esize for s in range(steps)}
            sizes.update({f"W{s}": bk * ldw * esize for s in range(steps)})
            plan = plan_shared(self.program, self.order, buffer_of, sizes)
            _build.check_smem(FUNCTION, plan.total)
            body = self.program.emit(self.order,
                                     before=SyncPlanner(plan, buffer_of))
            tr, tc = thread_grid(bm, bn)
            defines = {"T": CTYPES[self.dtype], "BM": bm, "BN": bn, "BK": bk,
                       "KDIM": self.k, "LDX": ldx, "LDW": ldw, "TR": tr,
                       "TC": tc, "TM": bm // tr, "TN": bn // tc,
                       "NT": tr * tc, "ALPHA": cfloat(ALPHA)}
            text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("gemm_fused.cu"), defines,
                buffer_decls(plan, {b: "T" for b in sizes}), body)
            self._text = (text, plan.total)
        return self._text

    def _launch(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        global launches
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
        dev = x.device.index if x.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        tr, tc = thread_grid(self.bm, self.bn)
        with torch.cuda.device(x.device):
            kern.launch((m // self.bm, n // self.bn, 1), tr * tc,
                        [ctypes.c_void_p(x.data_ptr()),
                         ctypes.c_void_p(w.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()),
                         ctypes.c_int(m), ctypes.c_int(n)])
        launches += 1
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
