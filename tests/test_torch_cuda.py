"""The port's CUDA kernels and engine on the card: each kernel against its
plain version, and a paged engine run on the card token-identical to the
same run on the CPU.  Marked ``cuda``: they skip without a card.  On the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pg_ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeConfig  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,skv,causal,window,d", [
    (37, 37, True, None, 128), (64, 64, False, None, 64),
    (20, 90, True, None, 32), (130, 130, True, 16, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, sq, skv, causal,
                                    window, d):
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((2, 4, sq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 2, skv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, 2, skv, d), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), q, q)


def test_paged_gather_kernel_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        store = torch.randn((17, 8, 2, 32), generator=g, device=cuda).to(dtype)
        pt = torch.tensor([[0, 3, 3, 16], [5, 0, 1, 1]], dtype=torch.int32,
                          device=cuda)
        assert torch.equal(pg.paged_gather(store, pt),
                           pg_ref.paged_gather(store, pt))


def test_paged_engine_on_card_matches_cpu(cuda):
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                      vocab=256, qk_norm=True, dtype="float32").validate()
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), 6)
            for n in (5, 19, 33, 8, 19)]
    scfg = ServeConfig(max_len=48, capacity=3, paged=True, page_size=8,
                       prefill_chunk=16)
    outs = []
    for device in ("cpu", cuda):
        p = M.map_params(lambda path, _: _leaf(params, path).to(device),
                         M.param_shapes(cfg))
        eng = ContinuousEngine(p, cfg, scfg)
        uids = [eng.submit(t, n).uid for t, n in reqs]
        got = eng.run(max_steps=500)
        outs.append([got[u] for u in uids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree
