"""SIP integration for the fused RMSNorm kernel (registry-based), under the
JAX package's name, knob space and workloads."""

from __future__ import annotations

import numpy as np

from repro_torch.core.registry import Workload, sip_kernel
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace
from repro_torch.core.testing import dtype_name
from repro_torch.kernels.rmsnorm import kernel as K
from repro_torch.kernels.rmsnorm import ref

NAME = "rmsnorm_fused"


def _choices(dim: int, prefs) -> tuple[int, ...]:
    ch = tuple(c for c in prefs if dim % c == 0 and c <= dim)
    return ch or (dim,)


def space(*, rows: int, d: int, dtype: str = "float32") -> SearchSpace:
    return SearchSpace(knobs=(
        KnobSpec("br", _choices(rows, (256, 512, 128, 64, 32, 16, 8, 1))),
        KnobSpec("n_chunks", _choices(d, (4, 2, 8, 1))),
    ))


def _knobs(schedule: Schedule, **static):
    sp = space(**static)
    d = sp.default_knobs()
    d.update(schedule.knobs)
    return d["br"], d["n_chunks"]


def program_for(schedule: Schedule, **static):
    br, n_chunks = _knobs(schedule, **static)
    return K.make_program(br=br, d=static["d"], n_chunks=n_chunks,
                          dtype=static["dtype"], rows=static["rows"])


def signature_fn(x, gamma) -> dict:
    rows, d = x.shape
    return {"rows": int(rows), "d": int(d), "dtype": dtype_name(x.dtype)}


def _rmsnorm_args(rows: int, d: int):
    def make_args(rng: np.random.Generator):
        x = rng.standard_normal((rows, d)).astype(np.float32)
        g = rng.standard_normal((d,)).astype(np.float32)
        return [x, g]
    return make_args


WORKLOADS = (
    Workload("smoke_16x32", _rmsnorm_args(16, 32), suites=("smoke",)),
    Workload("deploy_64x128", _rmsnorm_args(64, 128)),
)


def build(schedule: Schedule, **static):
    br, n_chunks = _knobs(schedule, **static)
    program = program_for(schedule, **static)
    return K.RmsNormKernel(br=br, d=static["d"], n_chunks=n_chunks,
                           dtype=static["dtype"], rows=static["rows"],
                           order=schedule.resolve_order(program))


SPEC = sip_kernel(name=NAME, program_for=program_for, space_for=space,
                  oracle=ref.rmsnorm, signature_fn=signature_fn,
                  workloads=WORKLOADS)(build)
