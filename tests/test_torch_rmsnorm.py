"""The port's fused RMSNorm against the JAX package's on the CPU, inputs
drawn with numpy from a seed: the kernel's CPU face (``Program.execute``
over the row tiles) against ``pallas_rmsnorm`` in interpret mode at every
point of the reference's knob space of both registry workloads, at the
default order and at a seeded legal one (rtol = atol = 1e-5, float32 sums
in another order); the programs' instruction names, kinds and edges; and
the emitted CUDA text of every point of the space at the model's width."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.core.registry import registry as jregistry  # noqa: E402
from repro.kernels.rmsnorm import ref as jref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core.registry import registry as tregistry  # noqa: E402
from repro_torch.kernels._emit import random_legal_order  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as tkernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as tops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as tref  # noqa: E402

jkernels.load_all()
tkernels.load_all()

NAME = "rmsnorm_fused"
TOL = dict(rtol=1e-5, atol=1e-5)


def _static(workload):
    spec = jregistry.spec(NAME)
    wl = next(w for w in spec.workloads if w.name == workload)
    args = wl.make_args(np.random.default_rng(13))
    return args, spec.signature_fn(*args)


def _points(static):
    space = jregistry.spec(NAME).space_for(**static)
    names = [k.name for k in space.knobs]
    return [dict(zip(names, p))
            for p in itertools.product(*[k.choices for k in space.knobs])]


CASES = [(w.name, knobs) for w in jregistry.spec(NAME).workloads
         for knobs in _points(_static(w.name)[1])]


@pytest.mark.parametrize("workload,knobs", CASES,
                         ids=[f"{w}-{k['br']}-{k['n_chunks']}"
                              for w, k in CASES])
def test_cpu_face_matches_interpret_kernel_at_every_knob_point(workload,
                                                               knobs):
    args, static = _static(workload)
    tspec, jspec = tregistry.spec(NAME), jregistry.spec(NAME)
    assert [(k.name, k.choices) for k in tspec.space_for(**static).knobs] \
        == [(k.name, k.choices) for k in jspec.space_for(**static).knobs]
    prog = tspec.program_for(tcore.Schedule(knobs=knobs), **static)
    for order in (prog.default_order(), random_legal_order(prog, 7)):
        tk = tspec.build(tcore.Schedule(knobs=knobs, order=order), **static)
        jk = jspec.build(jcore.Schedule(knobs=knobs, order=order), **static)
        got = tk(*[torch.from_numpy(a) for a in args])
        want = jk(*[jnp.asarray(a) for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jprog = jspec.program_for(jcore.Schedule(knobs=knobs), **static)
        assert [(i.name, i.kind.value, i.inputs, i.outputs, i.buffer,
                 i.is_store, i.bytes, i.flops) for i in prog.instrs] == \
            [(i.name, i.kind.value, i.inputs, i.outputs, i.buffer,
              i.is_store, i.bytes, i.flops) for i in jprog.instrs]
        assert [sorted(d) for d in prog.deps] == \
            [sorted(d) for d in jprog.deps]
        assert prog.replications == jprog.replications


def test_plain_version_matches_reference_oracle():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 96)).astype(np.float32)
    g = rng.standard_normal(96).astype(np.float32)
    np.testing.assert_allclose(
        tref.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(g))), **TOL)
    assert tops.NAME == NAME and tkernel.EPS == jref.EPS == 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_knob_point_emits_at_the_model_width(dtype):
    """No point of the reference's space keeps a (br x d) tile in shared
    memory: every one emits a kernel with none, at (4096, 2560)."""
    static = {"rows": 4096, "d": 2560, "dtype": dtype}
    points = _points(static)
    assert len(points) == 32
    for knobs in points:
        kern = tops.build(tcore.Schedule(knobs=knobs), **static)
        text, smem = kern.source()
        assert smem == 0 and "/*@" not in text
        assert kern.threads == 32 * tkernel.WARPS
        assert text.count("store_chunk<") == knobs["n_chunks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(4096, 2560), (16, 32), (64, 128)])
def test_every_knob_point_moves_16_bytes_a_lane_where_its_chunk_allows(
        rows, d, dtype):
    """Each lane loads and stores whole 16-byte vectors (8 bf16 or 4 fp32)
    when a feature chunk is a whole number of them, which every point at
    d = 2560 is; a chunk of fewer (the smoke widths in bf16) takes scalar
    loads; a chunk of vectors that 32 lanes do not divide predicates the
    last one.  Schedules that differ only in the row tile emit one text."""
    static = {"rows": rows, "d": d, "dtype": dtype}
    esize = 4 if dtype == "float32" else 2
    by_chunks: dict[int, set] = {}
    for knobs in _points(static):
        kern = tops.build(tcore.Schedule(knobs=knobs), **static)
        text = kern.source()[0]
        cd = d // knobs["n_chunks"]
        vec = 16 // esize if cd * esize % 16 == 0 else 1
        nv = cd // vec
        assert kern.vec == vec and f"#define VEC {vec}\n" in text
        assert f"#define NV {nv}\n" in text
        assert f"#define VPT {-(-nv // 32)}\n" in text
        assert "#define BR " not in text
        if d == 2560:
            assert vec > 1
        by_chunks.setdefault(knobs["n_chunks"], set()).add(text)
    assert all(len(texts) == 1 for texts in by_chunks.values())
    if (d, dtype) == (32, "bfloat16"):
        assert tops.build(tcore.Schedule(knobs={"n_chunks": 8}),
                          **static).vec == 1        # 4 elements a chunk
    if (d, dtype) == (2560, "bfloat16"):
        assert tops.build(tcore.Schedule(knobs={"n_chunks": 8}),
                          **static).source()[0].count("#define NV 40\n") == 1


def test_launch_grid_fills_the_card_whatever_the_row_tile():
    """One warp per row, WARPS rows a block: (4096, 2560) launches 4096 /
    WARPS blocks at the reference's default row tile of 256, not 4096 / 256,
    and a row count that WARPS does not divide gets one more block."""
    static = {"rows": 4096, "d": 2560, "dtype": "bfloat16"}
    kern = tops.build(tcore.Schedule(), **static)
    assert kern.br == 256
    assert kern.grid(4096) == 4096 // tkernel.WARPS != 4096 // kern.br
    assert kern.grid(4096) >= 2 * 132            # two blocks per SM at least
    assert kern.grid(4097) == kern.grid(4096) + 1
    assert 4 <= tkernel.WARPS <= 8


def test_kernel_counts_no_launches_on_cpu():
    args, _ = _static("smoke_16x32")
    before = tkernel.launches
    tregistry.get(NAME)(*[torch.from_numpy(a) for a in args])
    assert tkernel.launches == before
