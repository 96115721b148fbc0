"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and loaded
with :mod:`ctypes`.  The first :func:`load` builds every source at once (one
``nvcc`` each, all started together) into ``build/repro_torch_kernels/`` at
the repository root; a library is named by a hash of its source and flags,
so a build is reused until the source changes.  Without ``nvcc``, or when a
build fails, :func:`load` raises: there is no fallback to the plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry points of each source: name -> argtypes (every one returns int,
#: the CUDA error of its launch)
SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_P]},
    "paged_gather": {
        "paged_gather": [_P, _P, _P, _LL, _LL, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: repro_torch compiles its CUDA kernels from "
            f"{CSRC} at first use and needs the CUDA toolkit (nvcc on PATH "
            "or /usr/local/cuda/bin/nvcc)")
    return path


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{stem: library path}``; raises on the first failed build,
    with the compiler's output."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = {src.stem: library_path(src) for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        # build to a private name, then rename: a concurrent builder never
        # loads a half-written library
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(nvcc, src, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, tmp, proc))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        libs[src.stem].with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, libs[src.stem])
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_log(stem: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``csrc/<stem>.cu``."""
    log = library_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building every kernel on
    first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            for name, path in paths.items():
                loaded = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(loaded, fn).argtypes = argtypes
                    getattr(loaded, fn).restype = ctypes.c_int
                _libs[name] = loaded
            lib = _libs[stem]
        return lib
