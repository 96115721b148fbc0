"""Schedule-parameterized fused RMSNorm: the program and its kernel.

:func:`make_program` is the JAX package's instruction stream for one
``br``-row tile (``repro/kernels/rmsnorm/kernel.py:26``): the feature
dimension in ``n_chunks`` pieces, each an x load and a sum of squares, then
the reciprocal RMS, then per piece a gamma load, the scaling and the store —
MEM loads whose placement SIP permutes against the reduction chain.  Each
instruction has two faces: a torch ``fn`` (the CPU face, run by
``Program.execute`` over the row tiles, as Pallas interpret mode runs the
reference off-TPU) and a CUDA ``src`` snippet that ``Program.emit`` lays out
in schedule order inside ``csrc/rmsnorm.cu``.

:class:`RmsNormKernel` is one schedule: on CPU tensors it runs the CPU face,
on CUDA tensors it emits, builds (once per text) and launches the CUDA
kernel, counting ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build, count_launch
from repro_torch.kernels._emit import cfloat, emit_kernel

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm/kernel.py:83"
FUNCTION = "rmsnorm_fused"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}
EPS = 1e-6
#: warps of a block; each warp normalizes one row, so the grid is
#: ceil(rows / WARPS) blocks whatever the row tile is
WARPS = 4

launches = 0


def make_program(*, br: int, d: int, n_chunks: int, dtype="float32",
                 rows: int = 0) -> Program:
    if d % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} must divide d {d}")
    replications = max(rows // br, 1) if rows else 1
    cd = d // n_chunks
    out_dtype = getattr(torch, dtype_name(dtype))
    esize = torch.empty((), dtype=out_dtype).element_size()
    instrs: list[Instr] = []

    def ld_x(env, c):
        return {f"x{c}": env["x_ref"][:, c * cd:(c + 1) * cd].float()}

    def ld_g(env, c):
        return {f"g{c}": env["g_ref"][0, c * cd:(c + 1) * cd].float()}

    def sq(env, c):
        x = env[f"x{c}"]
        return {f"ss{c}": (x * x).sum(dim=1, keepdim=True)}

    for c in range(n_chunks):
        instrs.append(Instr(name=f"ld_x{c}", kind=Kind.MEM, inputs=(),
                            outputs=(f"x{c}",), fn=functools.partial(ld_x, c=c),
                            buffer="x", bytes=br * cd * esize,
                            src=f"float x{c}[CPT]; load_chunk<{c}, false>(xr, "
                                f"x{c});"))
        instrs.append(Instr(name=f"sq{c}", kind=Kind.COMPUTE, inputs=(f"x{c}",),
                            outputs=(f"ss{c}",), fn=functools.partial(sq, c=c),
                            flops=2 * br * cd,
                            src=f"const float ss{c} = sum_sq(x{c});"))

    def rstd(env):
        tot = env["ss0"]
        for c in range(1, n_chunks):
            tot = tot + env[f"ss{c}"]
        return {"rstd": torch.rsqrt(tot / d + EPS)}

    total = " + ".join(f"ss{c}" for c in range(n_chunks))
    instrs.append(Instr(name="rstd", kind=Kind.COMPUTE,
                        inputs=tuple(f"ss{c}" for c in range(n_chunks)),
                        outputs=("rstd",), fn=rstd, flops=2 * br,
                        src=f"const float rstd = row_rstd({total});"))

    def scale(env, c):
        return {f"y{c}": env[f"x{c}"] * env["rstd"] * env[f"g{c}"]}

    def st_y(env, c):
        env["o_ref"][:, c * cd:(c + 1) * cd] = env[f"y{c}"].to(out_dtype)
        return {}

    for c in range(n_chunks):
        instrs.append(Instr(name=f"ld_g{c}", kind=Kind.MEM, inputs=(),
                            outputs=(f"g{c}",), fn=functools.partial(ld_g, c=c),
                            buffer="g", bytes=cd * esize,
                            src=f"float g{c}[CPT]; load_chunk<{c}, true>(gm, "
                                f"g{c});"))
        instrs.append(Instr(name=f"scale{c}", kind=Kind.COMPUTE,
                            inputs=(f"x{c}", "rstd", f"g{c}"),
                            outputs=(f"y{c}",), fn=functools.partial(scale, c=c),
                            flops=2 * br * cd,
                            src=f"float y{c}[CPT]; scale_chunk(x{c}, g{c}, "
                                f"rstd, y{c});"))
        instrs.append(Instr(name=f"st_y{c}", kind=Kind.MEM, inputs=(f"y{c}",),
                            outputs=(), fn=functools.partial(st_y, c=c),
                            buffer="o", is_store=True, bytes=br * cd * esize,
                            src=f"store_chunk<{c}>(yr, y{c});"))
    return Program(instrs, replications=replications)


class RmsNormKernel:
    """One schedule (row tile, feature chunks and order) of fused RMSNorm,
    both faces."""

    def __init__(self, *, br: int, d: int, n_chunks: int, dtype="float32",
                 rows: int = 0, order: Sequence[int] | None = None):
        self.br, self.d, self.n_chunks = br, d, n_chunks
        self.dtype = dtype_name(dtype)
        if self.dtype not in CTYPES:
            raise ValueError(f"rmsnorm_fused: dtype {self.dtype} is not one "
                             f"of {list(CTYPES)}")
        self.program = make_program(br=br, d=d, n_chunks=n_chunks,
                                    dtype=self.dtype, rows=rows)
        self.order = tuple(order) if order is not None \
            else self.program.default_order()
        if not self.program.is_legal(self.order):
            raise ValueError("illegal schedule order")
        self._text: str | None = None
        self._kernels: dict[int, _build.Kernel] = {}
        #: this schedule's own launches (the module's ``launches`` counts
        #: every schedule's, from every thread)
        self.launches = 0

    threads = 32 * WARPS

    @property
    def vec(self) -> int:
        """Elements per load: a 16-byte vector when every feature chunk is
        a whole number of them, else 1."""
        esize = 4 if self.dtype == "float32" else 2
        cd = self.d // self.n_chunks
        return 16 // esize if cd * esize % 16 == 0 else 1

    @staticmethod
    def grid(rows: int) -> int:
        """Blocks of a launch over ``rows`` rows: one warp per row."""
        return -(-rows // WARPS)

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes (none: every value lives in registers).  The row tile ``br``
        is not in it."""
        if self._text is None:
            cd = self.d // self.n_chunks
            nv = cd // self.vec
            vpt = -(-nv // 32)
            defines = {"T": CTYPES[self.dtype], "D": self.d,
                       "NCH": self.n_chunks, "CD": cd, "VEC": self.vec,
                       "NV": nv, "VPT": vpt, "CPT": vpt * self.vec,
                       "NW": WARPS, "NT": self.threads, "EPS": cfloat(EPS)}
            self._text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("rmsnorm.cu"), defines, "",
                self.program.emit(self.order))
        return self._text, 0

    def _launch(self, x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        for name, t in (("x", x), ("gamma", gamma)):
            if t.device.type != "cuda" or t.device != x.device:
                raise ValueError(f"rmsnorm_fused: {name} on {t.device}, x on "
                                 f"{x.device}; both must be on one CUDA "
                                 f"device")
            if dtype_name(t.dtype) != self.dtype or not t.is_contiguous():
                raise ValueError(f"rmsnorm_fused: {name} must be a contiguous "
                                 f"{self.dtype} tensor, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if self.vec > 1 and t.data_ptr() % 16:
                raise ValueError(f"rmsnorm_fused: {name} must start on a "
                                 f"16-byte boundary (the kernel moves 16 "
                                 f"bytes at a time)")
        if x.dim() != 2 or x.shape[1] != self.d \
                or tuple(gamma.shape) != (self.d,) or x.shape[0] % self.br:
            raise ValueError(f"rmsnorm_fused: x {tuple(x.shape)} gamma "
                             f"{tuple(gamma.shape)} do not fit this schedule "
                             f"(d {self.d}, row tile {self.br})")
        dev = x.device.index if x.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        out = torch.empty_like(x)
        if out.numel():
            with torch.cuda.device(x.device):
                kern.launch((self.grid(x.shape[0]), 1, 1), self.threads,
                            [ctypes.c_void_p(x.data_ptr()),
                             ctypes.c_void_p(gamma.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_int(x.shape[0])])
            count_launch(self)
        return out

    # ------------------------------------------------------------- CPU face
    def _execute(self, x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        rows, br = x.shape[0], self.br
        if rows % br:
            raise ValueError(f"row tile {br} must divide rows {rows}")
        out = torch.empty_like(x)
        g = gamma[None, :]
        for i in range(rows // br):
            self.program.execute({"x_ref": x[i * br:(i + 1) * br],
                                  "g_ref": g,
                                  "o_ref": out[i * br:(i + 1) * br]},
                                 self.order)
        return out

    def __call__(self, x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu" and gamma.device.type == "cpu":
            return self._execute(x, gamma)
        return self._launch(x, gamma)
