"""Schedule-parameterized SSD intra-chunk block: the program and its kernel.

:func:`make_program` is the JAX package's instruction stream for one
(chunk, head) grid cell (``repro/kernels/ssd/kernel.py:27``): four MEM
loads (C, B, the log-decays ``la``, the dt-weighted inputs x) that SIP
places against the two dots and the decay math, and the output store.  Each
instruction has two faces: a torch ``fn`` (the CPU face, run by
``Program.execute`` over the (G, H) grid, as Pallas interpret mode runs the
reference off-TPU) and a CUDA ``src`` snippet that ``Program.emit`` lays out
in schedule order inside the column-tile loop of ``csrc/ssd_intra.cu``.

The CUDA face cannot keep the whole chunk in one block at the model's chunk
(q = 256, n = 128: C and B alone are 256 KB in float32), so a block owns one
row tile of the chunk and walks the column tiles at and left of the
diagonal; see the template.  The decay maps every non-finite value to 0 on
both faces, as the reference's oracle does.  Both faces take the decay from
a float64 running sum and accumulate the two dots in float64, as the plain
version does (``ref.intra_chunk`` says why); the reference kernel works in
float32 throughout.

:class:`SsdKernel` is one schedule: on CPU tensors it runs the CPU face, on
CUDA tensors it emits, builds (once per text) and launches the CUDA kernel,
counting ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build
from repro_torch.kernels._emit import (SyncPlanner, buffer_decls,
                                       divisor_at_most, emit_kernel,
                                       plan_shared)

SOURCE = "src/repro_torch/csrc/ssd_intra.cu"
REPLACES = "src/repro/kernels/ssd/kernel.py:82"
FUNCTION = "ssd_intra_chunk"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}
#: rows of a block's tile of the chunk (and columns of each step's tile)
MAX_TILE = 64
NT = 256

launches = 0


def make_program(*, q: int, n: int, p: int, dtype="float32",
                 grid: int = 1) -> Program:
    esize = torch.empty((), dtype=getattr(torch, dtype_name(dtype))) \
        .element_size()
    out_dtype = getattr(torch, dtype_name(dtype))
    instrs: list[Instr] = []

    instrs.append(Instr(
        name="ld_c", kind=Kind.MEM, inputs=(), outputs=("c",),
        fn=lambda env: {"c": env["c_ref"][0].float()},
        buffer="c", bytes=q * n * esize,
        src="if (first) load_rows(cp, Cs, r0);"))
    instrs.append(Instr(
        name="ld_b", kind=Kind.MEM, inputs=(), outputs=("b",),
        fn=lambda env: {"b": env["b_ref"][0].float()},
        buffer="b", bytes=q * n * esize,
        src="load_rows(bp, Bs, kb);"))
    instrs.append(Instr(
        name="ld_la", kind=Kind.MEM, inputs=(), outputs=("la",),
        fn=lambda env: {"la": env["la_ref"][0, 0].float()},
        buffer="la", bytes=q * esize,
        src="if (first) load_la(lp, h, LA);"))
    instrs.append(Instr(
        name="ld_x", kind=Kind.MEM, inputs=(), outputs=("x",),
        fn=lambda env: {"x": env["x_ref"][0, :, 0].float()},
        buffer="x", bytes=q * p * esize,
        src="load_x(xp, h, Xs, kb);"))

    instrs.append(Instr(
        name="dot_cb", kind=Kind.COMPUTE, inputs=("c", "b"), outputs=("s",),
        fn=lambda env: {"s": (env["c"].double()
                              @ env["b"].double().T).float()},
        flops=2 * q * q * n, src="cb_tile(Cs, Bs, S);"))

    def decay(env):
        cum = torch.cumsum(env["la"].double(), dim=0)       # (Q, 1)
        diff = cum - cum[:, 0][None, :]                      # (Q, Q) i,j
        idx = torch.arange(q)
        mask = idx[:, None] >= idx[None, :]
        L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)),
                        0.0).float()
        return {"L": torch.where(torch.isfinite(L), L, 0.0)}

    instrs.append(Instr(name="decay", kind=Kind.COMPUTE, inputs=("la",),
                        outputs=("L",), fn=decay, flops=4 * q * q,
                        src="decay_tile(LA, CUM, L, r0, kb, first);"))
    instrs.append(Instr(name="mask_mul", kind=Kind.COMPUTE,
                        inputs=("s", "L"), outputs=("w",),
                        fn=lambda env: {"w": env["s"] * env["L"]},
                        flops=q * q, src="mul_tile(S, L);"))
    instrs.append(Instr(
        name="dot_y", kind=Kind.COMPUTE, inputs=("w", "x"), outputs=("y",),
        fn=lambda env: {"y": (env["w"].double()
                              @ env["x"].double()).float()},
        flops=2 * q * q * p, src="y_tile(S, Xs, acc);"))

    def store(env):
        env["o_ref"][0, :, 0] = env["y"].to(out_dtype)
        return {}

    instrs.append(Instr(name="st_y", kind=Kind.MEM, inputs=("y",), outputs=(),
                        fn=store, buffer="o", is_store=True,
                        bytes=q * p * esize,
                        src="if (last) store_y(yp, h, acc, r0);"))
    return Program(instrs, replications=grid)


def thread_grids(br: int, p: int) -> dict[str, int]:
    """(CR x CC) threads over a score tile's (rows, columns), (YR x YC) over
    the output tile's (rows, head-dim columns)."""
    cc = divisor_at_most(br, 16)
    cr = divisor_at_most(br, NT // cc)
    yc = divisor_at_most(p, 32)
    yr = divisor_at_most(br, NT // yc)
    return {"CR": cr, "CC": cc, "CM": br // cr, "CN": br // cc,
            "YR": yr, "YC": yc, "YM": br // yr, "YN": p // yc}


class SsdKernel:
    """One schedule (an order; the space has no knobs) of the SSD
    intra-chunk kernel, both faces."""

    def __init__(self, *, q: int, n: int, p: int, dtype="float32",
                 grid: int = 1, order: Sequence[int] | None = None):
        self.q, self.n, self.p = q, n, p
        self.dtype = dtype_name(dtype)
        if self.dtype not in CTYPES:
            raise ValueError(f"ssd_intra_chunk: dtype {self.dtype} is not one "
                             f"of {list(CTYPES)}")
        self.program = make_program(q=q, n=n, p=p, dtype=self.dtype,
                                    grid=grid)
        self.order = tuple(order) if order is not None \
            else self.program.default_order()
        if not self.program.is_legal(self.order):
            raise ValueError("illegal schedule order")
        self.br = divisor_at_most(q, MAX_TILE)
        self._text: tuple[str, int] | None = None
        self._kernels: dict[int, _build.Kernel] = {}

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes; raises ``UnassemblableSchedule`` when that exceeds a block."""
        if self._text is None:
            q, n, p, br = self.q, self.n, self.p, self.br
            ldc, lds = n + 1, br + 1          # odd strides: no bank conflicts
            buffer_of = {"c": "Cs", "b": "Bs", "la": "LA", "x": "Xs",
                         "s": "S", "w": "S", "L": "L"}
            sizes = {"Cs": br * ldc * 4, "Bs": br * ldc * 4, "LA": q * 4,
                     "CUM": q * 8, "Xs": br * p * 4, "S": br * lds * 4,
                     "L": br * lds * 4}
            plan = plan_shared(self.program, self.order, buffer_of, sizes,
                               pinned=("Cs", "LA", "CUM"))
            _build.check_smem(FUNCTION, plan.total)
            body = self.program.emit(self.order,
                                     before=SyncPlanner(plan, buffer_of))
            defines = {"T": CTYPES[self.dtype], "Q": q, "N": n, "P": p,
                       "BR": br, "NT": NT, "LDC": ldc, "LDS": lds,
                       **thread_grids(br, p)}
            text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("ssd_intra.cu"), defines,
                buffer_decls(plan, {b: "double" if b == "CUM" else "float"
                                    for b in sizes}), body)
            self._text = (text, plan.total)
        return self._text

    def _check(self, xb, la, B, C) -> None:
        for name, t in (("xb", xb), ("la", la), ("B", B), ("C", C)):
            if t.device.type != "cuda" or t.device != xb.device:
                raise ValueError(f"ssd_intra_chunk: {name} on {t.device}, xb "
                                 f"on {xb.device}; all must be on one CUDA "
                                 f"device")
            if dtype_name(t.dtype) != self.dtype or not t.is_contiguous():
                raise ValueError(f"ssd_intra_chunk: {name} must be a "
                                 f"contiguous {self.dtype} tensor, got "
                                 f"{t.dtype} {tuple(t.shape)} strides "
                                 f"{t.stride()}")
        g, q, h, p = xb.shape
        if (q, p) != (self.q, self.p) or tuple(la.shape) != (g, q, h) \
                or tuple(B.shape) != (g, q, self.n) or B.shape != C.shape:
            raise ValueError(f"ssd_intra_chunk: xb {tuple(xb.shape)} la "
                             f"{tuple(la.shape)} B {tuple(B.shape)} C "
                             f"{tuple(C.shape)} do not fit this schedule "
                             f"(q {self.q}, n {self.n}, p {self.p})")

    def _launch(self, xb, la, B, C) -> torch.Tensor:
        global launches
        self._check(xb, la, B, C)
        g, q, h, p = xb.shape
        dev = xb.device.index if xb.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        out = torch.empty_like(xb)
        if out.numel():
            with torch.cuda.device(xb.device):
                kern.launch((g, h, q // self.br), NT,
                            [ctypes.c_void_p(xb.data_ptr()),
                             ctypes.c_void_p(la.data_ptr()),
                             ctypes.c_void_p(B.data_ptr()),
                             ctypes.c_void_p(C.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_int(h)])
            launches += 1
        return out

    # ------------------------------------------------------------- CPU face
    def _execute(self, xb, la, B, C) -> torch.Tensor:
        g, q, h, p = xb.shape
        la3 = la.movedim(-1, 1)[..., None]                  # (G, H, Q, 1)
        out = torch.empty_like(xb)
        for i in range(g):
            for j in range(h):
                self.program.execute(
                    {"c_ref": C[i:i + 1], "b_ref": B[i:i + 1],
                     "la_ref": la3[i:i + 1, j:j + 1],
                     "x_ref": xb[i:i + 1, :, j:j + 1],
                     "o_ref": out[i:i + 1, :, j:j + 1]}, self.order)
        return out

    def __call__(self, xb: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor) -> torch.Tensor:
        """xb: (G, Q, H, P) dt-weighted inputs; la: (G, Q, H) log-decays;
        B, C: (G, Q, N).  Returns (G, Q, H, P)."""
        if all(t.device.type == "cpu" for t in (xb, la, B, C)):
            return self._execute(xb, la, B, C)
        return self._launch(xb, la, B, C)
