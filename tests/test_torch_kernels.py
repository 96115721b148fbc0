"""The plain versions of the port's kernels against the JAX package's
kernels, which run in interpret mode here, and its oracles: flash attention
within rtol = atol = 1e-5 in float32, the paged gather exactly.  The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as jfa  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.kernels.paged_attention import kernel as jpg  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as tpg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (b, hq, hkv, sq, skv, d, causal, window, bq, bk) — bq/bk are the JAX
# kernel's tile sizes and must divide its lengths
FLASH_CASES = [
    (1, 2, 2, 16, 16, 8, True, None, 8, 8),
    (2, 4, 2, 16, 16, 32, True, None, 8, 8),        # GQA group 2
    (2, 4, 2, 16, 16, 32, False, None, 8, 16),      # bidirectional
    (1, 4, 2, 8, 24, 8, True, None, 8, 8),          # sq < skv, right-aligned
    (1, 4, 2, 24, 24, 32, True, 8, 8, 8),           # window 8
    (1, 2, 1, 16, 16, 8, False, 8, 16, 8),          # bidirectional window
]


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_oracle(case):
    b, hq, hkv, sq, skv, d, causal, window, bq, bk = case
    q, k, v = _qkv(np.random.default_rng(sq * d + hq), b, hq, hkv, sq, skv, d)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    want_kernel = jfa.pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq, bk=bk,
        causal=causal, window=window, interpret=True)
    want_ref = jfa_ref.attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    assert tfa.launches == 0


def test_flash_fully_masked_rows_are_finite_zero():
    """sq > skv with a causal mask leaves the first rows no key: they must
    come out 0, as the reference clamps l at 1e-30."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 2, 1, 8, 4, 8)
    got = tfa_ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True)
    want = jfa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    assert torch.isfinite(got).all()
    assert float(got[0, :, :4].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bf16_plain_casts_back():
    q, k, v = _qkv(np.random.default_rng(1), 1, 4, 2, 16, 16, 32)
    got = tfa.flash_attention(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(k).bfloat16(),
                              torch.from_numpy(v).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jfa_ref.attention(jnp.asarray(q, jnp.bfloat16),
                             jnp.asarray(k, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("shape,table", [
    ((8, 8, 2, 8), [[0, 3, 3, 7], [5, 0, 1, 1]]),       # repeats + trash page
    ((19, 8, 2, 32), [[1, 2, 3, 4, 5, 6], [7, 8, 9, 0, 0, 0],
                      [0, 0, 0, 0, 0, 0]]),
])
def test_paged_gather_plain_matches_jax_kernel(shape, table):
    store = np.random.default_rng(len(table)).standard_normal(shape)
    store = store.astype(np.float32)
    pt = np.asarray(table, np.int32)
    got = tpg.paged_gather(torch.from_numpy(store), torch.from_numpy(pt))
    want = jpg.paged_gather(jnp.asarray(store), jnp.asarray(pt), rows=2,
                            n_chunks=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tpg.launches == 0


def test_paged_gather_page_ids_outside_the_store_follow_the_jax_kernel():
    """Ids outside [0, P): the JAX kernel's index map wraps [-P, 0) by +P
    and clamps the rest into [0, P - 1]; the port's plain version and the
    kernel's CPU face read the same pages (P = 4: ids 0, -1, 5, -6 read
    pages 0, 3, 3, 0), where the JAX oracle's jnp.take gives NaN rows."""
    store = np.random.default_rng(4).standard_normal((4, 8, 2, 8))
    store = store.astype(np.float32)
    pt = np.asarray([[0, -1, 5, -6]], np.int32)
    want = np.asarray(jpg.paged_gather(jnp.asarray(store), jnp.asarray(pt),
                                       rows=2, n_chunks=2, interpret=True))
    np.testing.assert_array_equal(want, store[[[0, 3, 3, 0]]])
    face = tpg.GatherKernel(ps=8, h=2, d=8, rows=2, n_chunks=2)
    for got in (tpg.paged_gather(torch.from_numpy(store), torch.from_numpy(pt)),
                face(torch.from_numpy(store), torch.from_numpy(pt))):
        np.testing.assert_array_equal(got.numpy(), want)
    assert tpg.launches == 0


@pytest.mark.parametrize("wrapper", ["flash", "ssd", "gather"])
def test_wrappers_refuse_a_differentiated_call(wrapper):
    """Off the CPU, a call that autograd would record raises before any
    build or launch: the kernels have no backward (the model runs their
    plain versions with ``use_pallas`` off, as training does).  Meta
    tensors stand in for the card."""
    from repro_torch.kernels.ssd import ops as tsk_ops

    def meta(*shape):
        return torch.zeros(shape, device="meta", requires_grad=True)
    calls = {
        "flash": lambda: tfa.flash_attention(meta(1, 2, 8, 32),
                                             meta(1, 2, 8, 32),
                                             meta(1, 2, 8, 32)),
        "ssd": lambda: tsk_ops.ssd_chunked_kernel(
            meta(1, 40, 2, 8), meta(1, 40, 2), meta(2), meta(1, 40, 4),
            meta(1, 40, 4), meta(2), chunk=16),
        "gather": lambda: tpg.paged_gather(
            meta(4, 2, 2, 8), torch.zeros((1, 2), dtype=torch.int32,
                                          device="meta"))}
    with pytest.raises(RuntimeError, match="no backward"):
        calls[wrapper]()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()          # past the guard: the kernel refuses meta


def test_wrappers_reject_mixed_devices():
    """A CPU tensor beside a non-CPU one is not a CPU call: the wrapper
    validates for its kernel and refuses, it never falls back."""
    q = torch.zeros((1, 2, 4, 32))
    meta = torch.zeros((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tpg.paged_gather(torch.zeros((4, 2, 2, 8), device="meta"),
                         torch.zeros((1, 2), dtype=torch.int32))
