"""The port's SSD against the JAX package's on the CPU, inputs drawn with
numpy from a seed:

* the intra-chunk kernel's CPU face (``Program.execute`` over the grid)
  against ``pallas_ssd_intra`` in interpret mode, at the default and at 4
  seeded legal orders, on both registry workloads (rtol = atol = 1e-5,
  float32 sums in another order);
* the programs' instruction names, kinds and edges equal to the reference's;
* ``chunked.ssd_chunked`` / ``ssd_step`` against ``repro.kernels.ssd.ops``,
  the naive oracle against ``ref.ssd`` and the intra-chunk plain version
  against the reference's oracle (rtol = atol = 1e-4: float32 sums of up to
  S = 64 terms in another order);
* the padded ``ssd_chunked_kernel`` against the reference's unpadded
  ``ssd_chunked`` at ragged lengths (y and the final state, 1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.core.registry import registry as jregistry  # noqa: E402
from repro.kernels.ssd import kernel as jkernel  # noqa: E402
from repro.kernels.ssd import ops as jops  # noqa: E402
from repro.kernels.ssd import pallas_ops as jpallas  # noqa: E402
from repro.kernels.ssd import ref as jref  # noqa: E402
from repro.models.ssm import _best_chunk  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core.energy import UnassemblableSchedule  # noqa: E402
from repro_torch.core.registry import registry as tregistry  # noqa: E402
from repro_torch.kernels._emit import random_legal_order  # noqa: E402
from repro_torch.kernels.ssd import chunked  # noqa: E402
from repro_torch.kernels.ssd import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd import ops as tops  # noqa: E402
from repro_torch.kernels.ssd import ref as tref  # noqa: E402

jkernels.load_all()
tkernels.load_all()

NAME = "ssd_intra_chunk"
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
WORKLOADS = [w.name for w in jregistry.spec(NAME).workloads]


def _args(workload, seed=11):
    spec = jregistry.spec(NAME)
    wl = next(w for w in spec.workloads if w.name == workload)
    args = wl.make_args(np.random.default_rng(seed))
    return args, spec.signature_fn(*args)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _fields(prog):
    return ([(i.name, i.kind.value, i.inputs, i.outputs, i.buffer,
              i.is_store, i.bytes, i.flops) for i in prog.instrs],
            prog.replications, [sorted(d) for d in prog.deps])


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [None, 1, 2, 3, 4])
def test_cpu_face_matches_interpret_kernel(workload, seed):
    args, static = _args(workload)
    tspec, jspec = tregistry.spec(NAME), jregistry.spec(NAME)
    prog = tspec.program_for(tcore.Schedule(), **static)
    order = prog.default_order() if seed is None \
        else random_legal_order(prog, seed)
    tk = tspec.build(tcore.Schedule(order=order), **static)
    jk = jspec.build(jcore.Schedule(order=order), **static)
    got = tk(*_t(*args))
    want = jk(*_j(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    text, smem = tk.source()
    assert "/*@" not in text and smem <= 232_448
    assert "cb_tile(Cs, Bs, S, CBP);" in text and "y_tile(W, Xs, acc);" in text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,n,p", [(8, 8, 4), (16, 16, 8), (64, 128, 64),
                                   (256, 128, 64)])
def test_programs_equal_reference(q, n, p, dtype):
    jprog = jkernel.make_program(q=q, n=n, p=p, dtype=jnp.dtype(dtype),
                                 grid=6)
    tprog = tkernel.make_program(q=q, n=n, p=p, dtype=dtype, grid=6)
    assert _fields(tprog) == _fields(jprog)
    assert [i.name for i in tprog.instrs] == [
        "ld_c", "ld_b", "ld_la", "ld_x", "dot_cb", "decay", "mask_mul",
        "dot_y", "st_y"]


@pytest.mark.parametrize("q", [8, 16, 64, 256])
def test_every_legal_order_assembles_at_full_width(q):
    """The default and 24 random legal orders fit one block at the model's
    widths (n 128, p 64) for every chunk the model's path uses."""
    prog = tkernel.make_program(q=q, n=128, p=64, grid=80)
    for seed in [None] + list(range(24)):
        order = None if seed is None else random_legal_order(prog, seed)
        try:
            smem = tkernel.SsdKernel(q=q, n=128, p=64, order=order).source()[1]
        except UnassemblableSchedule:          # pragma: no cover - reported
            pytest.fail(f"q {q} order seed {seed} does not assemble")
        assert smem <= 232_448


def _legal_orders(prog):
    """Every order of ``prog`` that its dependencies allow."""
    deps, n, out = prog.deps, len(prog.instrs), []

    def walk(order):
        if len(order) == n:
            out.append(tuple(order))
        for i in range(n):
            if i not in order and deps[i] <= set(order):
                walk(order + [i])
    walk([])
    return out


@pytest.mark.parametrize("q", [8, 16, 64, 256])
def test_every_legal_order_assembles_with_a_head_group(q):
    """Each of the program's legal orders fits one block at the model's
    widths (n 128, p 64) with HG > 1 heads a block, which form C Bᵀ once,
    and waits for each cp.async group before its first reader."""
    from tests.test_torch_core import replay_async_groups
    prog = tkernel.make_program(q=q, n=128, p=64, grid=80)
    orders = _legal_orders(prog)
    assert len(orders) == 140 and prog.default_order() in orders
    for order in orders:
        kern = tkernel.SsdKernel(q=q, n=128, p=64, order=order)
        text, smem = kern.source()
        assert smem <= 232_448 and kern.layout["HG"] == tkernel.HEADS > 1
        assert "#define HG 2\n" in text
        assert text.count("cb_tile(Cs, Bs, S, CBP);") == 1
        assert replay_async_groups(kern.program, text) == 4


@pytest.mark.parametrize("q", [8, 256])
def test_random_orders_wait_for_their_groups(q):
    """replay_async_groups holds the SSD body at the orders
    random_legal_order gives for seeds 0-15: ld_c and ld_la copy on the
    first step only but commit a group on every step."""
    from tests.test_torch_core import replay_async_groups
    prog = tkernel.make_program(q=q, n=128, p=64, grid=80)
    for seed in range(16):
        kern = tkernel.SsdKernel(q=q, n=128, p=64,
                                 order=random_legal_order(prog, seed))
        text = kern.source()[0]
        assert replay_async_groups(kern.program, text) == 4
        assert text.count("cp_async_commit();") == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_dots_run_on_the_fp64_tensor_cores(dtype):
    """The body's two dots call the fp64 mma wrapper (DMMA m16n8k4), and no
    scalar fp64 FMA loop is left in the kernel."""
    text = tkernel.SsdKernel(q=256, n=128, p=64, dtype=dtype).source()[0]
    kernel_part = text[text.index("#define FULL_MASK"):]
    assert "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64" in text
    for fn in ("cb_tile", "y_tile"):
        start = kernel_part.index(f"void {fn}(")
        end = kernel_part.index("\n}\n", start)
        assert "mma_f64_1684(" in kernel_part[start:end], fn
    assert "fma(" not in kernel_part
    assert "cp_async_n<" in kernel_part and "load_rows(bp, Bs, kb); " \
        "cp_async_commit();" in text


@pytest.mark.parametrize("g,q,h,blocks", [(1, 256, 80, (40, 8, 1)),
                                          (6, 64, 80, (240, 2, 1)),
                                          (2, 8, 3, (4, 1, 1))])
def test_grid_takes_heads_in_groups(g, q, h, blocks):
    """A block owns (chunk, HG heads, row tile); a head count HG does not
    divide gets a last group with a zero-filled tail."""
    kern = tkernel.SsdKernel(q=q, n=128, p=64)
    assert kern.grid(g, q, h, kern.br) == blocks


def test_signature_and_space_equal_reference():
    for workload in WORKLOADS:
        args, static = _args(workload)
        assert tregistry.spec(NAME).signature_fn(*_t(*args)) == static
        assert tops.space(**static).knobs == ()


def _ssd_inputs(rng, bt, s, h, p, n):
    x = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((bt, s, h))) * 0.5).astype(np.float32)
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((bt, s, n)).astype(np.float32)
    C = rng.standard_normal((bt, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    rng = np.random.default_rng(3)
    args = _ssd_inputs(rng, 2, 64, 3, 4, 8)
    init = rng.standard_normal((2, 3, 8, 4)).astype(np.float32) \
        if with_state else None
    want_y, want_st = jops.ssd_chunked(
        *_j(*args), chunk=16, return_state=True,
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_st = chunked.ssd_chunked(
        *_t(*args), chunk=16, return_state=True,
        init_state=None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    # the naive oracle agrees with the chunked form, as in the reference
    np.testing.assert_allclose(tref.ssd(*_t(*args)).numpy(),
                               np.asarray(jref.ssd(*_j(*args))), **TOL)


def test_ssd_step_matches_reference_and_chunked_at_one_token():
    rng = np.random.default_rng(4)
    x, dt, A, B, C, D = _ssd_inputs(rng, 3, 1, 4, 8, 16)
    state = rng.standard_normal((3, 4, 16, 8)).astype(np.float32)
    want_st, want_y = jops.ssd_step(*_j(state, x[:, 0], dt[:, 0], A,
                                        B[:, 0], C[:, 0], D))
    got_st, got_y = chunked.ssd_step(*_t(state, x[:, 0], dt[:, 0], A,
                                         B[:, 0], C[:, 0], D))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    # the reference's decode continuation runs ssd_chunked at S = 1
    ref_y, ref_st = jops.ssd_chunked(*_j(x, dt, A, B, C, D), chunk=1,
                                     init_state=jnp.asarray(state),
                                     return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y)[:, 0], **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(ref_st), **TOL)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_intra_chunk_plain_matches_reference_oracle(workload):
    args, _ = _args(workload, seed=5)
    np.testing.assert_allclose(tref.intra_chunk(*_t(*args)).numpy(),
                               np.asarray(jpallas._oracle(*_j(*args))),
                               **KERNEL_TOL)


def test_intra_chunk_plain_maps_overflowing_decay_to_zero():
    """A positive log-decay whose running sum passes float32's range gives
    a decay of 0, never inf or NaN, as the reference's oracle maps it."""
    xb = np.ones((1, 4, 1, 2), np.float32)
    la = np.array([[[0.0], [60.0], [60.0], [0.0]]], np.float32)
    B = C = np.ones((1, 4, 3), np.float32)
    got = tref.intra_chunk(*_t(xb, la, B, C)).numpy()
    want = np.asarray(jpallas._oracle(*_j(xb, la, B, C)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("s", [37, 100, 130])
def test_padded_ssd_chunked_kernel_matches_unpadded_reference(s):
    """The port pads a ragged prompt to a multiple of min(chunk, 64) where
    the reference takes the largest power of two dividing it (chunks of 1
    at odd lengths); y on the real rows and the final state are the same."""
    rng = np.random.default_rng(s)
    args = _ssd_inputs(rng, 2, s, 3, 4, 8)
    init = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    want_y, want_st = jops.ssd_chunked(*_j(*args), chunk=_best_chunk(s),
                                       return_state=True)
    got_y, got_st = tops.ssd_chunked_kernel(*_t(*args), chunk=256,
                                            return_state=True)
    assert tops.padded_chunk(s, 256) == (64, -(-s // 64) * 64)
    assert tuple(got_y.shape) == (2, s, 3, 4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    # with an incoming state the padded rows add nothing to it either
    want_y, want_st = jops.ssd_chunked(*_j(*args), chunk=_best_chunk(s),
                                       init_state=jnp.asarray(init),
                                       return_state=True)
    got_y, got_st = tops.ssd_chunked_kernel(
        *_t(*args), chunk=16, init_state=torch.from_numpy(init),
        return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)


@pytest.mark.parametrize("s", [64, 100])
def test_kernel_inputs_are_contiguous_float32(s):
    """The kernel takes contiguous float32 rows: the model's B and C are
    column slices of the conv output, and at a length the chunk divides
    nothing is padded, so the slices must still be copied."""
    rng = np.random.default_rng(s)
    conv = torch.from_numpy(rng.standard_normal((2, s, 40)).astype(np.float32))
    x = conv[..., :24].reshape(2, s, 3, 8)
    B, C = conv[..., 24:32], conv[..., 32:]
    dt = torch.rand(2, s, 3)
    assert not B.is_contiguous()
    chunk, xb, la, Br, Cr = tops.kernel_inputs(x, dt, -torch.rand(3), B, C,
                                               chunk=64)
    assert chunk == 64 and xb.shape == (2 * (-(-s // 64)), 64, 3, 8)
    for t in (xb, la, Br, Cr):
        assert t.is_contiguous() and t.dtype == torch.float32
    # the CUDA face's argument checks pass but for the device
    kern = tops.build(tcore.Schedule(), **tops.signature_fn(xb, la, Br, Cr))
    with pytest.raises(ValueError, match="CUDA device"):
        kern._check(xb, la, Br, Cr)


def test_padded_chunk_keeps_a_dividing_chunk():
    assert tops.padded_chunk(512, 256) == (256, 512)
    assert tops.padded_chunk(256, 256) == (256, 256)
    assert tops.padded_chunk(384, 256) == (64, 384)
    assert tops.padded_chunk(33, 16) == (16, 48)


def test_kernel_counts_no_launches_on_cpu():
    args, static = _args(WORKLOADS[0])
    before = tkernel.launches
    tregistry.get(NAME)(*_t(*args))
    assert tkernel.launches == before
