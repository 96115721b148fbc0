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
row tile of the chunk for a group of ``HEADS`` heads, forms C Bᵀ once for
the group and walks the column tiles at and left of the diagonal; its loads
are ``cp.async`` copies whose waits follow the order, and both dots run on
the fp64 tensor cores; see the template.  The decay maps every non-finite
value to 0 on both faces, as the reference's oracle does.  Both faces take
the decay from a float64 running sum and accumulate the two dots in
float64, as the plain version does (``ref.intra_chunk`` says why); the
reference kernel works in float32 throughout.

:class:`SsdKernel` is one schedule: on CPU tensors it runs the CPU face, on
CUDA tensors it emits, builds (once per text) and launches the CUDA kernel,
counting ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.energy import UnassemblableSchedule
from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build, count_launch
from repro_torch.kernels._emit import (AsyncPlanner, buffer_decls,
                                       divisor_at_most, emit_kernel,
                                       plan_shared)

SOURCE = "src/repro_torch/csrc/ssd_intra.cu"
REPLACES = "src/repro/kernels/ssd/kernel.py:82"
FUNCTION = "ssd_intra_chunk"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}
#: rows of a block's tile of the chunk (and columns of each step's tile):
#: 32-row tiles keep a block under half an SM's shared memory, so two
#: blocks share each SM (at 64 rows one block fills it; PERF.md §6)
MAX_TILE = 32
#: heads of a block: C Bᵀ is formed once for them
HEADS = 2
#: slices of N that the warps split C Bᵀ into, and groups of warps that
#: split a block's heads in W x (each warp then owns more tiles of one
#: product, so fewer fp32 operands are widened per DMMA)
CB_SLICES = 2
HEAD_SPLIT = 2
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
        src="if (first) load_rows(cp, Cs, r0); cp_async_commit();"))
    instrs.append(Instr(
        name="ld_b", kind=Kind.MEM, inputs=(), outputs=("b",),
        fn=lambda env: {"b": env["b_ref"][0].float()},
        buffer="b", bytes=q * n * esize,
        src="load_rows(bp, Bs, kb); cp_async_commit();"))
    instrs.append(Instr(
        name="ld_la", kind=Kind.MEM, inputs=(), outputs=("la",),
        fn=lambda env: {"la": env["la_ref"][0, 0].float()},
        buffer="la", bytes=q * esize,
        src="if (first) load_la(lp, h, h0, LA); cp_async_commit();"))
    instrs.append(Instr(
        name="ld_x", kind=Kind.MEM, inputs=(), outputs=("x",),
        fn=lambda env: {"x": env["x_ref"][0, :, 0].float()},
        buffer="x", bytes=q * p * esize,
        src="load_x(xp, h, h0, Xs, kb); cp_async_commit();"))

    instrs.append(Instr(
        name="dot_cb", kind=Kind.COMPUTE, inputs=("c", "b"), outputs=("s",),
        fn=lambda env: {"s": (env["c"].double()
                              @ env["b"].double().T).float()},
        flops=2 * q * q * n, src="cb_tile(Cs, Bs, S, CBP);"))

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
                        flops=q * q, src="mul_tile(S, L, CUM, W, r0, kb);"))
    instrs.append(Instr(
        name="dot_y", kind=Kind.COMPUTE, inputs=("w", "x"), outputs=("y",),
        fn=lambda env: {"y": (env["w"].double()
                              @ env["x"].double()).float()},
        flops=2 * q * q * p, src="y_tile(W, Xs, acc);"))

    def store(env):
        env["o_ref"][0, :, 0] = env["y"].to(out_dtype)
        return {}

    instrs.append(Instr(name="st_y", kind=Kind.MEM, inputs=("y",), outputs=(),
                        fn=store, buffer="o", is_store=True,
                        bytes=q * p * esize,
                        src="if (last) store_y(yp, h, h0, acc, r0);"))
    return Program(instrs, replications=grid)


def _pad_words(width: int, esize: int, residue: int) -> int:
    """A row stride of at least ``width`` elements that keeps 16-byte
    copies aligned and, in float32, is ``residue`` words past a multiple of
    32, so the warp's fragment reads hit 32 different banks."""
    if esize == 4:
        return width + (residue - width) % 32
    return -(-width // 8) * 8 + 8


def _copy_bytes(nbytes: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides a row."""
    for w in (16, 8, 4):
        if nbytes % w == 0:
            return w
    raise UnassemblableSchedule(f"{FUNCTION}: a row of {nbytes} bytes is not "
                                f"a whole number of 4-byte copies")


def layout(q: int, n: int, p: int, esize: int) -> dict[str, int]:
    """The CUDA face's tile geometry: BR rows (and columns) of the chunk per
    tile, padded to BRP (16 or 32) for the 16 x 8 x 4 instruction; MT
    16-row strips.  C Bᵀ: KS slices of KSL along N, NJC 8-column tiles a
    warp.  W x: HS warp groups of HPW heads each; in a group, YM strips by
    YN 8-column tiles a warp, YWM warps down the strips.  Row strides LDC
    (C, B), LDX (x), LDS (S), LDW (W, fp64), LDP (C Bᵀ's partial sums) and
    copy widths CW, XW in bytes."""
    warps = NT // 32
    br = divisor_at_most(q, MAX_TILE)
    brp = 16 if br <= 16 else 32
    mt = brp // 16
    pp = -(-p // 8) * 8
    ks, hs = CB_SLICES, HEAD_SPLIT
    wps, wph = warps // ks, warps // hs
    per = -(-mt * pp // 8 // wph)          # output tiles a warp, per head
    ym = mt if per >= mt else 1
    ldw = brp + 4                 # 4 doubles past 16: fragment reads conflict-free
    return {"BR": br, "BRP": brp, "MT": mt, "PP": pp, "HG": HEADS,
            "KS": ks, "KSL": -(-n // ks // 4) * 4,
            "NJC": -(-(brp // 8) // (wps // mt)),
            "HS": hs, "HPW": HEADS // hs, "YM": ym, "YN": -(-per // ym),
            "YWM": mt // ym, "LDC": _pad_words(n, esize, 4),
            "LDX": _pad_words(HEADS * p, esize, 8),
            "LDS": _pad_words(brp, 4, 4), "LDW": ldw, "WSZ": brp * ldw,
            "LDP": brp + 8, "CW": _copy_bytes(n * esize),
            "XW": _copy_bytes(p * esize)}


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
        #: this schedule's own launches (the module's ``launches`` counts
        #: every schedule's)
        self.launches = 0

    @functools.cached_property
    def layout(self) -> dict[str, int]:
        """The CUDA face's tile geometry (:func:`layout`); raises
        ``UnassemblableSchedule`` for rows no cp.async can copy."""
        return layout(self.q, self.n, self.p,
                      4 if self.dtype == "float32" else 2)

    @staticmethod
    def grid(g: int, q: int, h: int, br: int) -> tuple[int, int, int]:
        """(chunks x head groups, row tiles, 1)."""
        return g * -(-h // HEADS), q // br, 1

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes; raises ``UnassemblableSchedule`` when that exceeds a block."""
        if self._text is None:
            q, n, p, lay = self.q, self.n, self.p, self.layout
            esize = 4 if self.dtype == "float32" else 2
            brp, hg = lay["BRP"], lay["HG"]
            buffer_of = {"c": "Cs", "b": "Bs", "la": "LA", "x": "Xs",
                         "s": "S", "L": "L", "w": "W"}
            sizes = {"Cs": brp * lay["LDC"] * esize,
                     "Bs": brp * lay["LDC"] * esize, "LA": q * hg * esize,
                     "CUM": hg * q * 8, "Xs": brp * lay["LDX"] * esize,
                     "S": brp * lay["LDS"] * 4, "L": 2 * hg * brp * 8,
                     "W": hg * lay["WSZ"] * 8,
                     "CBP": (lay["KS"] - 1) * brp * lay["LDP"] * 8}
            plan = plan_shared(self.program, self.order, buffer_of, sizes,
                               pinned=("Cs", "LA", "CUM", "CBP"))
            _build.check_smem(FUNCTION, plan.total)
            # fp64 accumulators: a warp's C Bᵀ tiles and its output tiles
            _build.check_regs(FUNCTION, NT, 8 * (
                lay["NJC"] + lay["HPW"] * lay["YM"] * lay["YN"]))
            body = self.program.emit(self.order,
                                     before=AsyncPlanner(plan, buffer_of))
            defines = {"T": CTYPES[self.dtype], "Q": q, "N": n, "P": p,
                       "NT": NT, **lay}
            ctype = {"CUM": "double", "L": "double", "W": "double",
                     "CBP": "double", "S": "float"}
            text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("ssd_intra.cu"), defines,
                buffer_decls(plan, {b: ctype.get(b, "T") for b in sizes}),
                body)
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
        self._check(xb, la, B, C)
        lay = self.layout
        for name, t, align in (("xb", xb, lay["XW"]), ("B", B, lay["CW"]),
                               ("C", C, lay["CW"])):
            if t.data_ptr() % align:
                raise ValueError(f"ssd_intra_chunk: {name} must start on a "
                                 f"{align}-byte boundary (the kernel copies "
                                 f"{align} bytes at a time)")
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
                kern.launch(self.grid(g, q, h, self.br), NT,
                            [ctypes.c_void_p(xb.data_ptr()),
                             ctypes.c_void_p(la.data_ptr()),
                             ctypes.c_void_p(B.data_ptr()),
                             ctypes.c_void_p(C.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_int(h)])
            count_launch(self)
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
