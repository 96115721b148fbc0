"""SIP integration for the paged-KV gather (registry-based).

One kernel, ``paged_gather``: the page-table-indirect cache read the paged
serving path puts in front of attention.  Registered declaratively under the
JAX package's name, so ``launch/tune.py --smoke`` tunes it like any other
kernel and the serving engine resolves the ONE registry-cached instance
bound to the active ``schedule_cache`` scope.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.registry import (KernelHandle, Workload, registry,
                                       sip_kernel)
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace
from repro_torch.core.testing import dtype_name
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref

NAME = "paged_gather"


def _divisors(dim: int, prefs: tuple[int, ...]) -> tuple[int, ...]:
    ch = tuple(c for c in prefs if dim % c == 0 and c <= dim)
    return ch or (1,)


def space(*, p, ps, h, d, b, n, dtype="float32") -> SearchSpace:
    """Copy-tiling knobs: ``rows`` splits the page's ps positions into row
    blocks, ``n_chunks`` splits the head dim — together they set the tile
    count of the movable load/store stream."""
    return SearchSpace(knobs=(
        KnobSpec("rows", _divisors(ps, (1, 2, 4, 8))),
        KnobSpec("n_chunks", _divisors(d, (1, 2, 4))),
    ))


def _knobs(schedule: Schedule, **static):
    sp = space(**static)
    k = sp.default_knobs()
    k.update(schedule.knobs)
    return k["rows"], k["n_chunks"]


def program_for(schedule: Schedule, **static):
    rows, n_chunks = _knobs(schedule, **static)
    return K.make_program(ps=static["ps"], h=static["h"], d=static["d"],
                          rows=rows, n_chunks=n_chunks, dtype=static["dtype"],
                          total_pages=static["b"] * static["n"])


def signature_fn(store, page_table) -> dict:
    p, ps, h, d = store.shape
    b, n = page_table.shape
    return {"p": int(p), "ps": int(ps), "h": int(h), "d": int(d),
            "b": int(b), "n": int(n), "dtype": dtype_name(store.dtype)}


def _gather_args(p: int, ps: int, h: int, d: int, b: int, n: int):
    def make_args(rng: np.random.Generator):
        store = rng.standard_normal((p, ps, h, d)).astype(np.float32)
        pt = rng.integers(0, p, (b, n)).astype(np.int32)
        return [store, pt]
    return make_args


@sip_kernel(
    name=NAME, program_for=program_for, space_for=space,
    oracle=ref.paged_gather, signature_fn=signature_fn,
    workloads=[
        Workload("smoke_p8_ps8_h2_d8_b2_n4", _gather_args(8, 8, 2, 8, 2, 4),
                 suites=("smoke",)),
        Workload("deploy_p64_ps16_h4_d32_b8_n8",
                 _gather_args(64, 16, 4, 32, 8, 8)),
    ])
def build(schedule: Schedule, **static):
    rows, n_chunks = _knobs(schedule, **static)
    program = program_for(schedule, **static)
    return K.GatherKernel(ps=static["ps"], h=static["h"], d=static["d"],
                          rows=rows, n_chunks=n_chunks, dtype=static["dtype"],
                          total_pages=static["b"] * static["n"],
                          order=schedule.resolve_order(program))


def kernel():
    """The shared registry instance bound to the active schedule cache —
    the serving resolution path."""
    return registry.get(NAME)


# late-binding handle: honors the schedule_cache scope active at call time
paged_gather = KernelHandle(NAME)
