"""SIP integration for the fused GEMM+LeakyReLU kernel (registry-based).

The kernel registers a declarative :class:`KernelSpec` under the JAX
package's name — six callables plus its own deployment workloads — so the
offline driver and deployment resolve it by name through
``repro_torch.core.registry``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.registry import KernelHandle, Workload, sip_kernel
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace
from repro_torch.core.testing import dtype_name
from repro_torch.kernels.gemm_fused import kernel as K
from repro_torch.kernels.gemm_fused import ref

NAME = "gemm_fused_leaky_relu"


def _knob_choices(dim: int, prefs: tuple[int, ...]) -> tuple[int, ...]:
    ch = tuple(c for c in prefs if dim % c == 0 and c <= dim)
    return ch or (dim,)


def space(*, m: int, n: int, k: int, dtype: str = "float32") -> SearchSpace:
    return SearchSpace(knobs=(
        KnobSpec("bm", _knob_choices(m, (128, 256, 512, 64, 32, 16, 8))),
        KnobSpec("bn", _knob_choices(n, (128, 256, 512, 64, 32, 16, 8))),
        KnobSpec("bk", _knob_choices(k, (128, 256, 512, 64, 32, 16, 8))),
    ))


def _blocks(schedule: Schedule, m: int, n: int, k: int, dtype: str):
    sp = space(m=m, n=n, k=k, dtype=dtype)
    d = sp.default_knobs()
    d.update(schedule.knobs)
    return d["bm"], d["bn"], d["bk"]


def program_for(schedule: Schedule, *, m: int, n: int, k: int,
                dtype: str = "float32"):
    bm, bn, bk = _blocks(schedule, m, n, k, dtype)
    return K.make_program(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype)


def signature_fn(x, w) -> dict:
    (m, k), (_, n) = x.shape, w.shape
    return {"m": int(m), "n": int(n), "k": int(k),
            "dtype": dtype_name(x.dtype)}


def _gemm_args(m: int, n: int, k: int):
    def make_args(rng: np.random.Generator):
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
        return [x, w]
    return make_args


WORKLOADS = (
    Workload("smoke_16x16x32", _gemm_args(16, 16, 32), suites=("smoke",)),
    Workload("deploy_64x64x128", _gemm_args(64, 64, 128)),
    Workload("deploy_128x128x256", _gemm_args(128, 128, 256)),
)


def build(schedule: Schedule, *, m: int, n: int, k: int,
          dtype: str = "float32"):
    bm, bn, bk = _blocks(schedule, m, n, k, dtype)
    program = program_for(schedule, m=m, n=n, k=k, dtype=dtype)
    return K.GemmKernel(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype,
                        order=schedule.resolve_order(program))


SPEC = sip_kernel(name=NAME, program_for=program_for, space_for=space,
                  oracle=ref.gemm_leaky_relu, signature_fn=signature_fn,
                  workloads=WORKLOADS)(build)

# late-binding handle: resolves the registry's shared instance — honoring
# the schedule_cache scope active at CALL time — on every use
gemm_leaky_relu = KernelHandle(NAME)
