"""Build, load and launch the port's emitted CUDA kernels.

Every kernel's body is emitted per schedule (``Program.emit`` inside the
template ``src/repro_torch/csrc/<kernel>.cu``), so the unit of a build is one
source text.  :func:`compile_many` runs one ``nvcc -cubin`` for Hopper
(``sm_90a``) per text, all started together, into
``build/repro_torch_kernels/`` at the repository root, next to the source
and the compiler's log; a cubin is named by a hash of its text and flags, so
a text is compiled once and then reused from disk.  :func:`load` maps the
cubin into PyTorch's CUDA context through the driver API (``libcuda``,
``cuModuleLoadData``) and memoizes the loaded function in memory;
:meth:`Kernel.launch` calls ``cuLaunchKernel`` on PyTorch's current stream.
Without ``nvcc``, or when a build fails, they raise: there is no fallback to
the plain path.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xptxas", "-v")
#: shared memory one block may use on the H100 (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232_448
#: 32-bit registers of an SM, which one block's threads share
REGS_PER_SM = 65_536
#: registers a thread needs beside its accumulators (addresses, indices,
#: fragments in flight); an estimate, not a count ptxas reports
REG_RESERVE = 40
#: dynamic shared memory above this needs an explicit opt-in per function
_SMEM_DEFAULT = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8


@dataclasses.dataclass
class BuildStats:
    """What the builds of this process cost: ``compiles`` nvcc runs (and
    their count per thread by name, ``compiles_by_thread``: a serving
    thread beside a tuning one) and their ``compile_s`` seconds, texts
    found on disk (``disk_hits``) or already loaded (``memo_hits``),
    ``compile_failures``, and schedules rejected before any compile because
    their shared memory exceeds :data:`SMEM_LIMIT` (``smem_rejections``) or
    their accumulators do not fit their threads' registers
    (``reg_rejections``)."""

    compiles: int = 0
    compile_s: float = 0.0
    disk_hits: int = 0
    memo_hits: int = 0
    compile_failures: int = 0
    smem_rejections: int = 0
    reg_rejections: int = 0
    compiles_by_thread: dict[str, int] = dataclasses.field(
        default_factory=dict)

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["s_per_compile"] = self.compile_s / self.compiles \
            if self.compiles else None
        return d

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default
                    if f.default_factory is dataclasses.MISSING
                    else f.default_factory())


STATS = BuildStats()
_lock = threading.Lock()
_kernels: dict[tuple[str, int], "Kernel"] = {}
#: one lock per text being built, so a thread loading a text that is built
#: already never waits on another thread's nvcc
_building: dict[tuple[str, int], threading.Lock] = {}
_templates: dict[str, str] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: repro_torch compiles each schedule's emitted "
            f"kernel (templates in {CSRC}) at first use and needs the CUDA "
            "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")
    return path


def template(filename: str) -> str:
    """The text of ``csrc/<filename>``, read once."""
    text = _templates.get(filename)
    if text is None:
        text = _templates[filename] = (CSRC / filename).read_text()
    return text


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def source_hash(source: str) -> str:
    h = hashlib.sha256(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def cubin_path(name: str, source: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(source)}.cubin"


def check_smem(name: str, nbytes: int) -> None:
    """Reject a schedule whose live shared-memory set does not fit a block."""
    if nbytes > SMEM_LIMIT:
        from repro_torch.core.energy import UnassemblableSchedule
        with _lock:
            STATS.smem_rejections += 1
        raise UnassemblableSchedule(
            f"{name}: this schedule keeps {nbytes} bytes of shared memory "
            f"live per block; a block on the H100 may use {SMEM_LIMIT}")


def check_regs(name: str, threads: int, live: int) -> None:
    """Reject a tile whose threads cannot hold their ``live`` fp32 values
    (accumulators and fragments) plus :data:`REG_RESERVE` each in the SM's
    register file, or that needs more than 1024 threads.  (A thread past
    255 registers in a smaller block is not rejected: ptxas spills the rest
    to local memory, slower but right.)"""
    if threads > 1024 or threads * (live + REG_RESERVE) > REGS_PER_SM:
        from repro_torch.core.energy import UnassemblableSchedule
        with _lock:
            STATS.reg_rejections += 1
        raise UnassemblableSchedule(
            f"{name}: {threads} threads keeping {live} values live each "
            f"(+{REG_RESERVE}) need more than the {REGS_PER_SM} registers "
            f"of an SM, or more than 1024 threads")


def compile_many(texts: Sequence[tuple[str, str]]) -> list[Path]:
    """Compile ``(name, source)`` texts whose cubin is missing, one nvcc
    each, two per CPU core in flight (the next starts as soon as one
    ends).  Returns the cubin paths in order; raises on any failed build,
    with the compiler's output."""
    paths = [cubin_path(name, src) for name, src in texts]
    todo, seen = [], set()
    for (name, src), path in zip(texts, paths):
        if path.exists() or path in seen:
            with _lock:
                STATS.disk_hits += path.exists()
            continue
        seen.add(path)
        todo.append((src, path))
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    failed = []

    def build(src: str, path: Path) -> None:
        cu = path.with_suffix(".cu")
        cu.write_text(src)
        # build to a private name, then rename: a concurrent builder never
        # loads a half-written cubin
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(nvcc_command(nvcc, cu, tmp),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        path.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {path.with_suffix('.cu')} "
                          f"(exit {proc.returncode}):\n{proc.stdout}")

    width = min(2 * (os.cpu_count() or 1), len(todo))
    with concurrent.futures.ThreadPoolExecutor(width) as pool:
        for fut in [pool.submit(build, src, path) for src, path in todo]:
            fut.result()
    thread = threading.current_thread().name
    with _lock:
        STATS.compiles += len(todo)
        STATS.compiles_by_thread[thread] = \
            STATS.compiles_by_thread.get(thread, 0) + len(todo)
        STATS.compile_s += time.perf_counter() - t0
        STATS.compile_failures += len(failed)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str, source: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the build of ``source``."""
    log = cubin_path(name, source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


# ------------------------------------------------------------- driver API
_CUresult = ctypes.c_int
_libcuda: ctypes.CDLL | None = None


def _cuda() -> ctypes.CDLL:
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        _P, _PP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        sigs = {
            "cuModuleLoadData": [_PP, _P],
            "cuModuleGetFunction": [_PP, _P, ctypes.c_char_p],
            "cuFuncSetAttribute": [_P, ctypes.c_int, ctypes.c_int],
            "cuLaunchKernel": [_P] + [ctypes.c_uint] * 7 + [_P, _PP, _PP],
            "cuCtxGetCurrent": [_PP],
            "cuCtxSetCurrent": [_P],
            "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
            "cuDevicePrimaryCtxRetain": [_PP, ctypes.c_int],
            "cuGetErrorString": [_CUresult, ctypes.POINTER(ctypes.c_char_p)],
        }
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _CUresult
        _libcuda = lib
    return _libcuda


def _check(res: int, what: str) -> None:
    if res != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(res, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUDA driver error {res} "
                           f"({(msg.value or b'?').decode()})")


def _primary_context(device: int) -> ctypes.c_void_p:
    torch.cuda.init()
    cu = _cuda()
    dev = ctypes.c_int()
    _check(cu.cuDeviceGet(ctypes.byref(dev), device), "cuDeviceGet")
    ctx = ctypes.c_void_p()
    _check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
           "cuDevicePrimaryCtxRetain")
    return ctx


class Kernel:
    """One ``extern "C" __global__`` function of a loaded cubin, bound to
    the primary context of one device (the context PyTorch uses)."""

    def __init__(self, cubin: Path, function: str, smem: int, device: int):
        cu = _cuda()
        self.ctx = _primary_context(device)
        self._make_current()
        self._image = cubin.read_bytes()      # kept alive with the module
        self.module = ctypes.c_void_p()
        _check(cu.cuModuleLoadData(ctypes.byref(self.module), self._image),
               f"cuModuleLoadData({cubin.name})")
        self.func = ctypes.c_void_p()
        _check(cu.cuModuleGetFunction(ctypes.byref(self.func), self.module,
                                      function.encode()),
               f"cuModuleGetFunction({function})")
        self.smem = smem
        if smem > _SMEM_DEFAULT:
            _check(cu.cuFuncSetAttribute(
                self.func, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                smem), f"cuFuncSetAttribute({function}, {smem} B)")
        self.name = function

    def _make_current(self) -> None:
        cu = _cuda()
        cur = ctypes.c_void_p()
        _check(cu.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != self.ctx.value:
            _check(cu.cuCtxSetCurrent(self.ctx), "cuCtxSetCurrent")

    def launch(self, grid: tuple[int, int, int], block: int,
               args: Sequence[ctypes._SimpleCData]) -> None:
        """Launch on PyTorch's current stream; raises if the launch is
        refused.  ``args`` are ctypes values in the kernel's order."""
        self._make_current()
        params = (ctypes.c_void_p * len(args))(
            *[ctypes.addressof(a) for a in args])
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        _check(_cuda().cuLaunchKernel(
            self.func, grid[0], grid[1], grid[2], block, 1, 1, self.smem,
            stream, params, None), f"cuLaunchKernel({self.name})")


def load(name: str, source: str, smem: int,
         device: int | None = None) -> Kernel:
    """The loaded ``extern "C"`` function ``name`` of ``source``, compiling
    the text if no cubin of it exists yet."""
    if device is None:
        device = torch.cuda.current_device()
    key = (source_hash(source), device)
    with _lock:
        kern = _kernels.get(key)
        if kern is not None:
            STATS.memo_hits += 1
            return kern
        building = _building.setdefault(key, threading.Lock())
    with building:            # nvcc runs outside the memo's lock
        with _lock:
            kern = _kernels.get(key)
        if kern is None:
            (path,) = compile_many([(name, source)])
            kern = Kernel(path, name, smem, device)
            with _lock:
                _kernels[key] = kern
                _building.pop(key, None)
    return kern
