"""SIP integration for the fused attention kernel (registry-based).

Attention is a *family* of kernels — (causal, window) variants share the
build/program/space callables but differ in oracle and name.  The common
variants register at import; :func:`kernel` resolves (and lazily registers)
any variant as ONE shared, registry-cached instance, so the model's
attention path never constructs fresh kernels per call.  Names, knob spaces
and workloads are the JAX package's, but for the order of the tile choices
at lengths that are multiples of 256 (see ``_BQ_PREFS``).
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.jit import SipKernel
from repro_torch.core.registry import (KernelHandle, KernelSpec, Workload,
                                       registry)
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace
from repro_torch.core.testing import dtype_name
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def _choices(dim: int, prefs: tuple[int, ...]) -> tuple[int, ...]:
    ch = tuple(c for c in prefs if dim % c == 0 and c <= dim)
    return ch or (dim,)


#: tile preferences: the JAX package's (256, 512, 128, ...) with 128 moved
#: first.  A (256, 256) tile keeps 264 KB of scores per block, more than the
#: card's 227 KB, so the reference's default at lengths that are multiples
#: of 256 cannot be assembled; there the default here is (128, 128).  At
#: every other length the choices and their order are the reference's.
_BQ_PREFS = (128, 256, 512, 64, 32, 16, 8, 1)
_BK_PREFS = (128, 256, 512, 64, 32, 16, 8)


def space(*, b, hq, hkv, sq, skv, d, causal, window, dtype="float32") -> SearchSpace:
    bks = _choices(skv, _BK_PREFS)
    return SearchSpace(knobs=(
        KnobSpec("bq", _choices(sq, _BQ_PREFS)),
        KnobSpec("bk", bks),
        KnobSpec("n_chunks", tuple(c for c in (2, 4, 1) if bks[0] % c == 0)),
    ))


def _knobs(schedule: Schedule, **static):
    sp = space(**static)
    d = sp.default_knobs()
    d.update(schedule.knobs)
    return d["bq"], d["bk"], d["n_chunks"]


def program_for(schedule: Schedule, **static):
    bq, bk, n_chunks = _knobs(schedule, **static)
    return K.make_program(bq=bq, bk=bk, n_chunks=n_chunks, d=static["d"],
                          sq=static["sq"], skv=static["skv"],
                          causal=static["causal"], window=static["window"],
                          dtype=static["dtype"],
                          batch_heads=static["b"] * static["hq"])


def build(schedule: Schedule, **static):
    bq, bk, n_chunks = _knobs(schedule, **static)
    program = program_for(schedule, **static)
    return K.FlashKernel(bq=bq, bk=bk, n_chunks=n_chunks, d=static["d"],
                         sq=static["sq"], skv=static["skv"],
                         causal=static["causal"], window=static["window"],
                         dtype=static["dtype"],
                         batch_heads=static["b"] * static["hq"],
                         order=schedule.resolve_order(program))


def variant_name(causal: bool = True, window: int | None = None) -> str:
    return "flash_attention" + ("_causal" if causal else "") + \
        (f"_w{window}" if window else "")


def _attn_args(b: int, hq: int, hkv: int, s: int, d: int):
    def make_args(rng: np.random.Generator):
        q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
        k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        return [q, k, v]
    return make_args


def register_variant(causal: bool, window: int | None,
                     workloads: tuple[Workload, ...] = ()) -> KernelSpec:
    """Register a (causal, window) variant, optionally with its own
    deployment workloads (declared here, next to the kernel, never in the
    launcher)."""
    def signature_fn(q, k, v) -> dict:
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        return {"b": int(b), "hq": int(hq), "hkv": int(hkv), "sq": int(sq),
                "skv": int(skv), "d": int(d), "causal": causal,
                "window": window, "dtype": dtype_name(q.dtype)}

    oracle = functools.partial(ref.attention, causal=causal, window=window)
    return registry.register(KernelSpec(
        name=variant_name(causal, window), build=build,
        program_for=program_for, space_for=space, oracle=oracle,
        signature_fn=signature_fn, workloads=workloads, module=__name__))


CAUSAL_SPEC = register_variant(True, None, workloads=(
    Workload("smoke_b1_h2kv2_s16_d8", _attn_args(1, 2, 2, 16, 8),
             suites=("smoke",)),
    Workload("deploy_b1_h4kv2_s128_d32", _attn_args(1, 4, 2, 128, 32)),
))
BIDIR_SPEC = register_variant(False, None)


def ensure_registered(causal: bool = True, window: int | None = None) -> str:
    """Name of the (causal, window) variant, registering it on first use."""
    name = variant_name(causal, window)
    if name not in registry:
        try:
            register_variant(causal, window)
        except ValueError:
            # lost a concurrent first-use race; the variant exists now
            if name not in registry:
                raise
    return name


def kernel(causal: bool = True, window: int | None = None) -> SipKernel:
    """The shared registry instance for a variant, bound to the active
    schedule cache — the model/serving resolution path."""
    return registry.get(ensure_registered(causal, window))


# late-binding handles: honor the schedule_cache scope active at call time
flash_attention = KernelHandle(variant_name(True, None))
flash_attention_bidir = KernelHandle(variant_name(False, None))
