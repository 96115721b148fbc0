"""Schedule-parameterized paged-KV gather: the program and its kernel.

``out[b, i] = store[page_table[b, i]]``.  :func:`make_program` is the JAX
package's per-page copy program (``repro/kernels/paged_attention/kernel.py:33``):
``rows`` row blocks x ``n_chunks`` head-dim chunks, one (load, store) MEM pair
per tile, with two faces per instruction — a torch ``fn`` (the CPU face,
run by ``Program.execute`` once per table entry) and a CUDA ``src`` snippet
that ``Program.emit`` lays out in schedule order inside
``csrc/paged_gather.cu``.

:class:`GatherKernel` is one schedule of the kernel: on CPU tensors it runs
the CPU face, on CUDA tensors it emits, builds (once per text) and launches
the CUDA kernel, counting ``launches``.  :func:`paged_gather` is the model's
entry point: the plain version on CPU tensors, the registry's shared
instance (``ops.paged_gather``, serving the active cache's schedule) on
CUDA tensors.  Page ids follow the reference kernel's contract on every
face (``ref.page_ids``): an id in [-P, 0) wraps to id + P, and then every
id is clamped into [0, P - 1].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build, count_launch, refuse_grad
from repro_torch.kernels._emit import emit_kernel
from repro_torch.kernels.paged_attention import ref

SOURCE = "src/repro_torch/csrc/paged_gather.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:65"
FUNCTION = "paged_gather"
DTYPES = ("float32", "bfloat16")
UNITS = {16: "uint4", 8: "uint2", 4: "unsigned", 2: "u16_t"}

launches = 0


def make_program(*, ps: int, h: int, d: int, rows: int, n_chunks: int,
                 dtype="float32", total_pages: int = 1) -> Program:
    """The per-grid-step copy program: ``rows`` row-blocks x ``n_chunks``
    d-chunks, one (load, store) MEM pair per tile."""
    if ps % rows or d % n_chunks:
        raise ValueError(f"rows {rows} must divide ps {ps} and n_chunks "
                         f"{n_chunks} must divide d {d}")
    rb, cd = ps // rows, d // n_chunks
    esize = torch.empty((), dtype=getattr(torch, dtype_name(dtype))) \
        .element_size()
    instrs: list[Instr] = []

    def ld(env, r, c):
        tile = env["store_ref"][r * rb:(r + 1) * rb, :, c * cd:(c + 1) * cd]
        return {f"t{r}_{c}": tile}

    def st(env, r, c):
        env["out_ref"][r * rb:(r + 1) * rb, :, c * cd:(c + 1) * cd] = \
            env[f"t{r}_{c}"]
        return {}

    for r in range(rows):
        for c in range(n_chunks):
            nbytes = rb * h * cd * esize
            instrs.append(Instr(
                name=f"ld_r{r}c{c}", kind=Kind.MEM, inputs=(),
                outputs=(f"t{r}_{c}",), fn=functools.partial(ld, r=r, c=c),
                buffer="store", bytes=nbytes,
                src=f"U t{r}_{c}[PER]; load_tile<{r}, {c}>(src, t{r}_{c});"))
            instrs.append(Instr(
                name=f"st_r{r}c{c}", kind=Kind.MEM, inputs=(f"t{r}_{c}",),
                outputs=(), fn=functools.partial(st, r=r, c=c),
                buffer="out", is_store=True, bytes=nbytes,
                src=f"store_tile<{r}, {c}>(dst, t{r}_{c});"))
    return Program(instrs, replications=total_pages)


class GatherKernel:
    """One schedule (tiling and order) of the paged gather, both faces."""

    def __init__(self, *, ps: int, h: int, d: int, rows: int, n_chunks: int,
                 dtype="float32", total_pages: int = 1,
                 order: Sequence[int] | None = None):
        self.ps, self.h, self.d = ps, h, d
        self.rows, self.n_chunks = rows, n_chunks
        self.dtype = dtype_name(dtype)
        if self.dtype not in DTYPES:
            raise ValueError(f"paged_gather: dtype {self.dtype} is not one of "
                             f"{list(DTYPES)}")
        self.program = make_program(ps=ps, h=h, d=d, rows=rows,
                                    n_chunks=n_chunks, dtype=self.dtype,
                                    total_pages=total_pages)
        self.order = tuple(order) if order is not None \
            else self.program.default_order()
        if not self.program.is_legal(self.order):
            raise ValueError("illegal schedule order")
        esize = 4 if self.dtype == "float32" else 2
        cd_bytes = d // n_chunks * esize
        self.unit = max(u for u in UNITS if cd_bytes % u == 0)
        self.page_bytes = ps * h * d * esize
        tile_units = (ps // rows) * h * cd_bytes // self.unit
        self.threads = min(256, -(-tile_units // 32) * 32)
        self._tile_units = tile_units
        self._text: str | None = None
        self._kernels: dict[int, _build.Kernel] = {}
        #: this schedule's own launches (the module's ``launches`` counts
        #: every schedule's, from every thread)
        self.launches = 0

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule (no shared memory)."""
        if self._text is None:
            esize = 4 if self.dtype == "float32" else 2
            defines = {"U": UNITS[self.unit], "NT": self.threads,
                       "H": self.h, "RB": self.ps // self.rows,
                       "DU": self.d * esize // self.unit,
                       "CDU": self.d // self.n_chunks * esize // self.unit,
                       "TU": self._tile_units,
                       "PER": -(-self._tile_units // self.threads),
                       "PAGE_UNITS": self.page_bytes // self.unit}
            self._text = emit_kernel(
                _build.template("sip_common.cuh")
                + _build.template("paged_gather.cu"), defines, "",
                self.program.emit(self.order))
        return self._text, 0

    def _launch(self, store: torch.Tensor,
                page_table: torch.Tensor) -> torch.Tensor:
        if store.device.type != "cuda" or page_table.device != store.device:
            raise ValueError(f"paged_gather: store on {store.device}, page "
                             f"table on {page_table.device}; both must be "
                             f"on one CUDA device")
        if dtype_name(store.dtype) != self.dtype or store.dim() != 4 \
                or not store.is_contiguous() or store.data_ptr() % 16 \
                or tuple(store.shape[1:]) != (self.ps, self.h, self.d):
            raise ValueError(f"paged_gather: store must be a contiguous, "
                             f"16-byte aligned {self.dtype} tensor (P, "
                             f"{self.ps}, {self.h}, {self.d}), got "
                             f"{store.dtype} {tuple(store.shape)} strides "
                             f"{store.stride()}")
        if page_table.dtype != torch.int32 or page_table.dim() != 2 \
                or not page_table.is_contiguous():
            raise ValueError(f"paged_gather: page table must be a contiguous "
                             f"2-D int32 tensor, got {page_table.dtype} "
                             f"{tuple(page_table.shape)}")
        b, n = page_table.shape
        out = torch.empty((b, n) + tuple(store.shape[1:]), dtype=store.dtype,
                          device=store.device)
        if b * n == 0:
            return out
        dev = store.device.index if store.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        with torch.cuda.device(store.device):
            kern.launch((b * n, 1, 1), self.threads,
                        [ctypes.c_void_p(store.data_ptr()),
                         ctypes.c_void_p(page_table.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()),
                         ctypes.c_int(store.shape[0])])
        count_launch(self)
        return out

    # ------------------------------------------------------------- CPU face
    def _execute(self, store: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
        b, n = page_table.shape
        out = torch.empty((b, n) + tuple(store.shape[1:]), dtype=store.dtype)
        pages = ref.page_ids(page_table, store.shape[0])
        for bi in range(b):
            for i in range(n):
                self.program.execute(
                    {"store_ref": store[int(pages[bi, i])],
                     "out_ref": out[bi, i]}, self.order)
        return out

    def __call__(self, store: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
        if store.device.type == "cpu" and page_table.device.type == "cpu":
            return self._execute(store, page_table)
        return self._launch(store, page_table)


def paged_gather(store: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """store: (P, ps, H, D); page_table: (B, n) int32 -> (B, n, ps, H, D).

    CPU tensors take the plain version; otherwise the registry's shared
    kernel serves the active cache's schedule.  A call that autograd would
    record raises (:func:`kernels.refuse_grad`): the kernel has no
    backward."""
    if store.device.type == "cpu" and page_table.device.type == "cpu":
        return ref.paged_gather(store, page_table)
    refuse_grad("paged_gather", store)
    from repro_torch.kernels.paged_attention import ops
    return ops.paged_gather(store, page_table)
