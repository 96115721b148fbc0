"""The CPU face of each kernel's ``build(schedule)`` — ``Program.execute``
with torch ``fn``s over the grid — against the JAX package's
interpret-mode Pallas kernel at the same knobs and order: at the smoke
workloads, at the default order and 5 seeded legal orders, and at a second
knob point.  Tolerance: the gather exactly (with negative page ids in the
table), gemm and flash within rtol = atol = 1e-5 in float32.  The emitted
CUDA text of every such schedule is checked for its template's marks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.core.registry import registry as jregistry  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core.registry import registry as tregistry  # noqa: E402
from repro_torch.kernels._emit import random_legal_order  # noqa: E402

jkernels.load_all()
tkernels.load_all()

TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = (None, 1, 2, 3, 4, 5)


def _smoke(name):
    spec = jregistry.spec(name)
    (wl,) = spec.workloads_in("smoke")
    args = wl.make_args(np.random.default_rng(11))
    return args, spec.signature_fn(*args)


def _pair(name, static, knobs, seed):
    """(port kernel, reference kernel) of one schedule."""
    tspec, jspec = tregistry.spec(name), jregistry.spec(name)
    prog = tspec.program_for(tcore.Schedule(knobs=knobs), **static)
    order = prog.default_order() if seed is None \
        else random_legal_order(prog, seed)
    return (tspec.build(tcore.Schedule(knobs=knobs, order=order), **static),
            jspec.build(jcore.Schedule(knobs=knobs, order=order), **static),
            order)


def _check_source(kern, marks):
    text, smem = kern.source()
    assert "/*@" not in text and smem <= 232_448
    for mark in marks:
        assert mark in text


@pytest.mark.parametrize("knobs", [{}, {"bm": 8, "bn": 16, "bk": 8}])
@pytest.mark.parametrize("seed", SEEDS)
def test_gemm_cpu_face_matches_interpret_kernel(seed, knobs):
    args, static = _smoke("gemm_fused_leaky_relu")
    tk, jk, _ = _pair("gemm_fused_leaky_relu", static, knobs, seed)
    got = tk(*[torch.from_numpy(a) for a in args])
    want = jk(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_source(tk, ["dot_tile(X0, W0, acc);", "gemm_fused_leaky_relu("])


@pytest.mark.parametrize("knobs", [{}, {"bq": 8, "bk": 8, "n_chunks": 4},
                                   {"bq": 1, "bk": 16, "n_chunks": 1}])
@pytest.mark.parametrize("seed", SEEDS)
def test_flash_cpu_face_matches_interpret_kernel(seed, knobs):
    args, static = _smoke("flash_attention_causal")
    tk, jk, _ = _pair("flash_attention_causal", static, knobs, seed)
    got = tk(*[torch.from_numpy(a) for a in args])
    want = jk(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_source(tk, ["softmax_rows(S, m_r,", "store_o(op, acc",
                       "mma_tf32_1688("])


@pytest.mark.parametrize("knobs", [{}, {"rows": 4, "n_chunks": 2}])
@pytest.mark.parametrize("seed", SEEDS)
def test_gather_cpu_face_matches_interpret_kernel(seed, knobs):
    (store, _), static = _smoke("paged_gather")
    # ids -1 and -8 (= -P) wrap to P-1 and 0 in the reference's gather
    pt = np.array([[0, -1, 3, -8], [7, -3, 7, 2]], np.int32)
    tk, jk, _ = _pair("paged_gather", static, knobs, seed)
    got = tk(torch.from_numpy(store), torch.from_numpy(pt))
    want = jk(jnp.asarray(store), jnp.asarray(pt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0, 1], store[7])
    _check_source(tk, ["load_tile<0, 0>(src, t0_0);"])


def test_scheduled_kernels_count_no_launches_on_cpu():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gemm_fused import kernel as gf
    from repro_torch.kernels.paged_attention import kernel as pg
    before = (fa.launches, gf.launches, pg.launches)
    for name in ("flash_attention_causal", "gemm_fused_leaky_relu",
                 "paged_gather"):
        args, _ = _smoke(name)
        tregistry.get(name)(*[torch.from_numpy(a) for a in args])
    assert (fa.launches, gf.launches, pg.launches) == before


@pytest.mark.parametrize("sq,skv,window", [(37, 37, None), (20, 90, None),
                                           (70, 70, 16)])
def test_padded_causal_call_matches_plain(sq, skv, window):
    """The model's causal calls reach the kernel padded to a multiple of
    SEQ_TILE; the kernel's CPU face at the padded lengths, cut back to the
    real rows, equals the plain attention at the real lengths."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    rng = np.random.default_rng(sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((1, 4, sq, 8), (1, 2, skv, 8), (1, 2, skv, 8)))
    kern = fa_ops.kernel(True, window)
    seen = []

    def spy(*args):
        seen.append(tuple(args[0].shape))
        return kern(*args)

    got = fa.padded(spy, q, k, v, causal=True)
    want = fa_ref.attention(q, k, v, causal=True, window=window)
    assert seen == [(1, 4, -(-sq // fa.SEQ_TILE) * fa.SEQ_TILE, 8)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # a bidirectional call is padded too and passes its real key length,
    # past which the kernel masks the padded keys
    given = []
    got = fa.padded(lambda *a, **kw: given.append((a[2].shape[2], kw)) or a[0],
                    q, k, v, causal=False)
    assert given == [(skv + seen[0][2] - sq, {"kv_len": skv})]
    assert torch.equal(got, q)
    # nor is a strided view, which the kernel rejects as it was given
    qt = q.transpose(2, 3)
    assert fa.padded(lambda *a: a[0], qt, k, v, causal=True) is qt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_default_schedule_assembles_at_every_padded_length(dtype, d):
    """Every length a causal model call reaches the kernel at has a default
    schedule whose live shared memory fits one block: in particular the
    multiples of 256, where the reference's default (256, 256) tile keeps
    264 KB of scores."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    for s in range(fa.SEQ_TILE, 2049, fa.SEQ_TILE):
        kern = fa_ops.build(tcore.Schedule(), b=1, hq=16, hkv=8, sq=s, skv=s,
                            d=d, causal=True, window=None, dtype=dtype)
        assert kern.bq >= fa.SEQ_TILE, s
        assert kern.source()[1] <= 232_448, s


FLASH_SERVE = dict(b=4, hq=16, hkv=8, sq=128, skv=128, d=128, causal=True,
                   window=None, dtype="bfloat16")


@pytest.mark.parametrize("seed", [None, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", ["serve_bf16", "smoke_bf16", "smoke_f32"])
def test_flash_schedules_assemble_or_reject_and_wait_for_their_groups(case,
                                                                      seed):
    """At every knob point, the default and 5 random legal orders: each
    schedule assembles within a block or raises UnassemblableSchedule, and
    its cp.async groups are complete before every read (bf16 and float32
    both load with cp.async)."""
    from tests.test_torch_core import check_schedules
    if case == "serve_bf16":
        static = FLASH_SERVE
    else:
        _, static = _smoke("flash_attention_causal")
        static = {**static, "dtype": case.split("_")[1].replace(
            "bf16", "bfloat16").replace("f32", "float32")}
    built, _ = check_schedules("flash_attention_causal", static, seed)
    assert built > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_ld_v_hoisted_order_overlaps_v_with_qk(dtype):
    """Hoisting each ld_v{c} next to its ld_k{c} leaves V's group in flight
    through Q K^T and the softmax: the first wait keeps groups pending, and
    the order needs more shared memory than the default."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from tests.test_torch_core import replay_async_groups
    static = {**FLASH_SERVE, "dtype": dtype}
    base = fa_ops.build(tcore.Schedule(), **static)
    prog = base.program
    names = [ins.name for ins in prog.instrs]
    order = [i for i in prog.default_order()
             if not names[i].startswith("ld_v")]
    for c in range(base.n_chunks):
        order.insert(order.index(names.index(f"ld_k{c}")) + 1,
                     names.index(f"ld_v{c}"))
    assert prog.is_legal(order)
    hoisted = fa_ops.build(tcore.Schedule(order=tuple(order)), **static)
    text, smem = hoisted.source()
    assert smem > base.source()[1]
    assert replay_async_groups(prog, text) == 2 * base.n_chunks + 2
    assert "cp_async_wait<1>();" in text


def _function(text, name):
    """The body of the CUDA function ``name`` in ``text``: from its
    signature to the first line that closes it."""
    start = text.index(f" {name}(")
    return text[start:text.index("\n}\n", start)]


def test_f32_flash_products_run_on_the_tensor_cores():
    """The float32 kernel's two products are 3xTF32 mma.sync (three
    products a k8 step), its scores stay in registers, and no fp32 FMA
    loop over shared memory is left."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    kern = fa_ops.build(tcore.Schedule(), **{**FLASH_SERVE,
                                             "dtype": "float32"})
    text, _ = kern.source()
    for name in ("qk_tile", "pv_tile"):
        body = _function(text, name)
        assert body.count("mma_tf32_1688(") == 3, name
        assert "split_trunc(" in body and "ldmatrix" not in body, name
    assert "fmaf" not in text and "float S[NCH][NTK][4];" in text
    assert "STATS" not in text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [37, 501])
def test_padded_bidirectional_call_matches_plain(s, dtype):
    """A bidirectional call at a ragged length reaches the kernel padded to
    a multiple of SEQ_TILE with its real key length, past which the keys
    are masked: the CPU face at the padded length equals the plain
    attention at the real one.  (Unpadded, 501 keys in f32 give the
    reference space's single 1 x 501 tile.)"""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(getattr(torch, dtype))
               for shape in ((1, 2, s, 8), (1, 1, s, 8), (1, 1, s, 8)))
    got = fa.padded(fa_ops.kernel(False, None), q, k, v, causal=False)
    want = fa_ref.attention(q, k, v, causal=False)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **tol)
