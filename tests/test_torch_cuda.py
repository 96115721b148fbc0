"""The port's CUDA kernels and engine on the card: each emitted kernel
against its plain version at the default and at seeded random legal orders
(the SSD intra-chunk kernel at the model's widths and at a head count its
head groups do not divide, RMSNorm at every point of its knob space and at
row counts its blocks do not divide, the tensor-core gemm at tiles smaller than its
instructions and at the paper's shape with a hoisted order, bf16 flash at
an ld_v-hoisted order in bf16 and float32, padded bidirectional flash
calls, flash at the hybrid's and the sliding-window model's head dims and
at dbrx's and llava's GQA ratios), the gather's page-id contract (wrap and
clamp), a paged engine run (dense, MoE and VLM) and contiguous hybrid and
sliding-window runs, a contiguous encoder-decoder run and a padded-heads
prefill and paged run on the card token-identical to the same runs on the
CPU, bidirectional flash at the encoder's shape (MHA, head_dim 64, 4,096
frames) and causal flash at its decoder's prompt, the MoE layer on the card against the CPU and bitwise repeatable,
an autotune promotion on the card that the running engine swaps to
and launches, and the continuous engine's captured decode step (tokens
equal eager dispatch's on qwen3 paged and contiguous and mamba2, captured
with no sync, the gather's credited launches equal to the eager count, a
promoted gather schedule launched on replay, a failed capture raising),
its captured whole-prompt prefills and chunk steps (tokens and flash,
gather and SSD launch counts equal eager dispatch's on qwen3 paged and
mamba2, re-captured after a swap in no more memory) and the captured train
step (losses equal eager steps' under remat "full" and "dots").
Marked ``cuda``: they skip without a card.  On the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels._emit import random_legal_order  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.gemm_fused import kernel as gf  # noqa: E402
from repro_torch.kernels.gemm_fused import ref as gf_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pg_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rk_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd import ops as sk_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as sk_ref  # noqa: E402
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,s,window,d", [(4, 4, 130, None, 112),
                                               (8, 2, 150, 16, 80)])
def test_flash_kernel_at_the_hybrid_and_window_head_dims(cuda, dtype, tol,
                                                         hq, hkv, s, window,
                                                         d):
    """zamba2's shared block (MHA at head_dim 112: 7 k16 steps) and
    h2o-danube's (GQA 4:1 at head_dim 80, a window shorter than S)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((2, hq, s, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, hkv, s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, hkv, s, d), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa_ref.attention(q, k, v, causal=True, window=window)
    assert fa.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv", [(48, 8), (56, 8)])
def test_flash_kernel_at_the_moe_and_vlm_ratios(cuda, dtype, tol, hq, hkv):
    """dbrx-132b (GQA 6:1) and llava-next-34b (7:1) at head_dim 128."""
    g = torch.Generator(device=cuda).manual_seed(hq)
    q = torch.randn((2, hq, 100, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, hkv, 100, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, hkv, 100, 128), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa_ref.attention(q, k, v, causal=True)
    assert fa.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_moe_on_card_matches_cpu_and_repeats_bitwise(cuda):
    """dbrx's layer (top-4 of 16, capacity factor 1.25) at smoke width:
    the card's bf16 result within the repo's bf16 tolerance (rtol = atol
    = 2e-2) of the CPU's, and two calls bitwise equal (the k copies are
    summed in a fixed order, with no atomics)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get_smoke("dbrx-132b"), n_experts=16,
                              top_k=4, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=gen) * s[-2] ** -0.5
         for k, s in moe.moe_shapes(cfg).items()}
    p = {k: v if k == "router" else v.to(torch.bfloat16)
         for k, v in p.items()}
    x = torch.randn((4, 64, cfg.d_model), generator=gen).to(torch.bfloat16)
    want, waux = moe.moe(p, x, cfg)
    pc = {k: v.to(cuda) for k, v in p.items()}
    got, aux = moe.moe(pc, x.to(cuda), cfg)
    again, _ = moe.moe(pc, x.to(cuda), cfg)
    assert torch.equal(got, again)
    err = (got.float().cpu() - want.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all())
    for k in aux:
        assert abs(float(aux[k]) - float(waux[k])) <= 2e-2 * abs(
            float(waux[k])) + 1e-6


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
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


def test_paged_gather_wraps_negative_ids(cuda):
    """Ids in [-P, 0) read page id + P, as the reference's jnp.take does;
    the plain version (torch indexing) wraps the same way."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        store = torch.randn((9, 8, 2, 32), generator=g, device=cuda).to(dtype)
        pt = torch.tensor([[-1, -9, 3, -4], [8, 0, -1, -2]],
                          dtype=torch.int32, device=cuda)
        got = pg.paged_gather(store, pt)
        assert torch.equal(got, pg_ref.paged_gather(store, pt))
        assert torch.equal(got[0, 0], store[8]) and torch.equal(got[0, 1],
                                                                store[0])


def test_paged_gather_clamps_ids_outside_the_store(cuda):
    """Ids outside [-P, P) read the page the JAX kernel reads: P = 4, ids
    0, -1, 5, -6 read pages 0, 3, 3, 0, as the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        store = torch.randn((4, 8, 2, 32), generator=g, device=cuda).to(dtype)
        pt = torch.tensor([[0, -1, 5, -6]], dtype=torch.int32, device=cuda)
        before = pg.launches
        got = pg.paged_gather(store, pt)
        assert pg.launches == before + 1
        assert torch.equal(got[0], store[[0, 3, 3, 0]])
        assert torch.equal(got, pg_ref.paged_gather(store, pt))


@pytest.mark.parametrize("seed", [None, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emitted_kernels_match_plain_at_legal_orders(cuda, seed, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator(device=cuda).manual_seed(seed or 0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    def order(kern):
        return None if seed is None else random_legal_order(kern.program,
                                                            seed)
    kw = dict(m=64, n=64, k=128, bm=32, bn=64, bk=32, dtype=dtype)
    gk = gf.GemmKernel(**kw)
    gk = gf.GemmKernel(**kw, order=order(gk))
    x, w = randn(64, 128), randn(128, 64)
    want = gf_ref.gemm_leaky_relu(x, w).float()
    err = (gk(x, w).float() - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item() / 8)
    kw = dict(bq=32, bk=32, n_chunks=2, d=64, sq=64, skv=64, causal=True,
              window=None, dtype=dtype)
    fk = fa.FlashKernel(**kw)
    fk = fa.FlashKernel(**kw, order=order(fk))
    q, k, v = randn(2, 4, 64, 64), randn(2, 2, 64, 64), randn(2, 2, 64, 64)
    err = (fk(q, k, v).float()
           - fa_ref.attention(q, k, v).float()).abs().max().item()
    assert err <= tol
    kw = dict(ps=8, h=2, d=32, rows=4, n_chunks=2, dtype=dtype)
    pk = pg.GatherKernel(**kw)
    pk = pg.GatherKernel(**kw, order=order(pk))
    store = randn(11, 8, 2, 32)
    pt = torch.tensor([[0, -1, 10, 3], [-11, 5, 5, 1]], dtype=torch.int32,
                      device=cuda)
    assert torch.equal(pk(store, pt), pg_ref.paged_gather(store, pt))


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


@pytest.mark.parametrize("arch", ["dbrx-132b", "llava-next-34b"])
def test_paged_moe_and_vlm_engines_on_card_match_cpu(cuda, arch):
    """dbrx (MoE, capacity factor 1.25: grouped prefills drop copies) and
    llava (embedding prompts) at smoke width on the paged engine, with a
    prompt past the chunk: the card's tokens equal the CPU's, and the card
    launched flash and the gather."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    reqs = []
    for n, b in ((20, 6), (37, 5), (20, 7), (9, 4)):
        extra = ({"embeds": rng.standard_normal((n, cfg.d_model)).astype(
            np.float32)} if cfg.input_mode == "embeddings" else None)
        reqs.append((rng.integers(1, cfg.vocab, n).astype(np.int32), b,
                     extra))
    scfg = ServeConfig(max_len=64, capacity=3, paged=True, page_size=8,
                       prefill_chunk=16)
    outs = []
    for device in ("cpu", cuda):
        p = M.map_params(lambda path, _: _leaf(params, path).to(device),
                         M.param_shapes(cfg))
        before = (fa.launches, pg.launches)
        eng = ContinuousEngine(p, cfg, scfg)
        uids = [eng.submit(t, n, extra=e).uid for t, n, e in reqs]
        got = eng.run(max_steps=500)
        outs.append([got[u] for u in uids])
        launched = (fa.launches - before[0], pg.launches - before[1])
        assert (launched == (0, 0)) == (device == "cpu")
        assert min(launched) > 0 or device == "cpu"
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "h2o-danube-1.8b"])
def test_contiguous_engine_on_card_matches_cpu(cuda, arch):
    """The hybrid (SSD and flash kernels) and the sliding-window model
    (flash at its window; prompts past the 32-token window, decodes that
    wrap its ring) at smoke width: the card's tokens equal the CPU's."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), b)
            for n, b in ((5, 6), (45, 4), (28, 12), (70, 5), (45, 7))]
    scfg = ServeConfig(max_len=96, capacity=3)
    outs = []
    for device in ("cpu", cuda):
        p = M.map_params(lambda path, _: _leaf(params, path).to(device),
                         M.param_shapes(cfg))
        before = (fa.launches, sk.launches)
        eng = ContinuousEngine(p, cfg, scfg)
        uids = [eng.submit(t, n).uid for t, n in reqs]
        got = eng.run(max_steps=500)
        outs.append([got[u] for u in uids])
        launched = (fa.launches - before[0], sk.launches - before[1])
        if device == "cpu":
            assert launched == (0, 0)
        else:
            assert launched[0] > 0
            assert (launched[1] > 0) == (cfg.family == "hybrid")
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_autotune_promotion_swaps_into_the_engine_on_card(cuda):
    """One service cycle on the card over a running engine's recorded mix
    promotes a flash schedule; the engine swaps and launches the kernel
    built from it, and its tokens equal the CPU's."""
    import json
    from repro_torch.autotune import (AutotuneConfig, AutotuneService,
                                      recorder_source, serve_targets)
    from repro_torch.core import Schedule, ScheduleCache, registry
    from repro_torch.core import schedule_cache
    from repro_torch.obs import WorkloadRecorder
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                      vocab=256, qk_norm=True, dtype="float32").validate()
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), 6)
            for n in (20, 20, 30, 30)]
    # two groups of two: the second prefills (2, 4, 64, 32) after the swap
    scfg = ServeConfig(max_len=48, capacity=2, paged=True, page_size=8)
    cpu = ContinuousEngine(params, cfg, scfg)
    uids = [cpu.submit(t, n).uid for t, n in reqs]
    got = cpu.run(max_steps=500)
    want = [got[u] for u in uids]

    p = M.map_params(lambda path, _: _leaf(params, path).to(cuda),
                     M.param_shapes(cfg))
    store, rec = ScheduleCache(), WorkloadRecorder()
    svc = AutotuneService(store, source=recorder_source(rec),
                          target_for=serve_targets(cfg, scfg),
                          config=AutotuneConfig(budget=2), device="cuda")
    with schedule_cache(store):
        eng = ContinuousEngine(p, cfg, scfg, recorder=rec)
        uids = [eng.submit(t, n).uid for t, n in reqs[:2]]
        eng.step()
        assert svc.run_once()["promoted"] >= 1
        uids += [eng.submit(t, n).uid for t, n in reqs[2:]]
        got = eng.run(max_steps=500)
    assert eng.stats["schedule_swaps"] == 1 and svc.metrics()["errors"] == 0
    for u, w in zip(uids, want):
        np.testing.assert_array_equal(got[u], w)
    (flash,) = [ev for ev in svc.log.events if ev["kind"] == "promoted"
                and ev["kernel"] == "flash_attention_causal"]
    kern = registry.get(flash["kernel"], store).built(
        json.loads(flash["signature"]), Schedule.from_json(
            flash["schedule_sig"]))
    assert kern is not None and kern.launches >= cfg.n_layers


@pytest.mark.parametrize("seed", [None, 1, 2])
@pytest.mark.parametrize("g,q,h,p,n", [(2, 8, 2, 4, 8), (3, 64, 80, 64, 128),
                                       (1, 256, 80, 64, 128),
                                       (1, 256, 112, 64, 64),
                                       (6, 64, 112, 64, 64)])
def test_ssd_kernel_matches_plain(cuda, g, q, h, p, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(q)
    xb = torch.randn((g, q, h, p), generator=gen, device=cuda)
    la = -torch.randn((g, q, h), generator=gen, device=cuda).abs() * 0.1
    B = torch.randn((g, q, n), generator=gen, device=cuda) * 0.3
    C = torch.randn((g, q, n), generator=gen, device=cuda) * 0.3
    base = sk.SsdKernel(q=q, n=n, p=p, grid=g * h)
    kern = base if seed is None else sk.SsdKernel(
        q=q, n=n, p=p, grid=g * h,
        order=random_legal_order(base.program, seed))
    before = sk.launches
    got = kern(xb, la, B, C)
    assert sk.launches == before + 1
    want = sk_ref.intra_chunk(xb, la, B, C)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_at_positive_log_decays(cuda):
    """The SIP tests draw la standard-normal: the decay reaches e^40 and
    more over 256 rows; kernel and plain version stay finite and agree to
    the tests' 2e-2."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = [torch.randn(s, generator=gen, device=cuda)
            for s in ((1, 256, 80, 64), (1, 256, 80), (1, 256, 128),
                      (1, 256, 128))]
    got = sk.SsdKernel(q=256, n=128, p=64)(*args)
    want = sk_ref.intra_chunk(*args)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("g,h", [(2, 3), (1, 80)])
def test_ssd_kernel_with_head_groups_matches_plain(cuda, g, h):
    """At serve-like la = dt A < 0: h = 3 leaves a last head group with one
    zero-filled head, h = 80 fills every group; q 256 walks four row
    tiles, heavy ones first."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    xb = torch.randn((g, 256, h, 64), generator=gen, device=cuda)
    la = -torch.randn((g, 256, h), generator=gen, device=cuda).abs() * 0.1
    B = torch.randn((g, 256, 128), generator=gen, device=cuda) * 0.3
    C = torch.randn((g, 256, 128), generator=gen, device=cuda) * 0.3
    got = sk.SsdKernel(q=256, n=128, p=64, grid=g * h)(xb, la, B, C)
    torch.testing.assert_close(got, sk_ref.intra_chunk(xb, la, B, C),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,n", [(5, 128), (40, 128), (7, 64), (56, 64)])
def test_ssd_kernel_at_the_split_head_counts(cuda, dtype, tol, h, n):
    """The head counts a rank runs when mamba2's 80 and zamba2's 112 SSD
    heads split 16 and 2 ways along "model" (5 and 7 leave zero-filled
    heads in a last head group), in both dtypes, against the plain version
    on the same rounded inputs; prints the largest per-row error."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    args = [torch.randn((1, 256, h, 64), generator=gen, device=cuda),
            -torch.randn((1, 256, h), generator=gen, device=cuda).abs() * 0.1,
            torch.randn((1, 256, n), generator=gen, device=cuda) * 0.3,
            torch.randn((1, 256, n), generator=gen, device=cuda) * 0.3]
    args = [a.to(dtype) for a in args]
    got = sk.SsdKernel(q=256, n=n, p=64, grid=h, dtype=dtype)(*args)
    want = sk_ref.intra_chunk(*[a.float() for a in args])
    rows = ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max()
    print(f"ssd h{h} n{n} {dtype}: max per-row error {rows.item():.3e}")
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_ssd_chunked_kernel_on_card_matches_cpu(cuda):
    gen = np.random.default_rng(0)
    x = gen.standard_normal((2, 100, 4, 8)).astype(np.float32)
    dt = np.abs(gen.standard_normal((2, 100, 4))).astype(np.float32) * 0.5
    A = -np.abs(gen.standard_normal(4)).astype(np.float32)
    B = gen.standard_normal((2, 100, 16)).astype(np.float32)
    C = gen.standard_normal((2, 100, 16)).astype(np.float32)
    D = gen.standard_normal(4).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        t = [torch.from_numpy(a).to(dev) for a in (x, dt, A, B, C, D)]
        outs.append([o.cpu() for o in sk_ops.ssd_chunked_kernel(
            *t, chunk=256, return_state=True)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_kernel_matches_plain_at_every_knob_point(cuda, dtype, tol):
    from repro_torch.kernels.rmsnorm import ops as rk_ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((512, 2560), generator=gen, device=cuda).to(dtype)
    g = torch.randn((2560,), generator=gen, device=cuda).to(dtype)
    want = rk_ref.rmsnorm(x, g).float()
    space = rk_ops.space(rows=512, d=2560, dtype=str(dtype)[6:])
    for br in space.knobs[0].choices:
        for nch in space.knobs[1].choices:
            base = rk.RmsNormKernel(br=br, d=2560, n_chunks=nch, dtype=dtype,
                                    rows=512)
            for kern in (base, rk.RmsNormKernel(
                    br=br, d=2560, n_chunks=nch, dtype=dtype, rows=512,
                    order=random_legal_order(base.program, br + nch))):
                got = kern(x, g).float()
                assert (got - want).abs().max().item() <= \
                    tol * max(1.0, want.abs().max().item() / 8)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,d", [(4097, 2560), (4098, 2560), (30, 32),
                                    (7, 128)])
def test_rmsnorm_kernel_at_rows_past_the_last_full_block(cuda, rows, d,
                                                         dtype, tol):
    """A row count that the block's WARPS rows do not divide: the last
    block's extra warps write nothing, every row is normalized."""
    from repro_torch.core import Schedule
    from repro_torch.kernels.rmsnorm import ops as rk_ops
    assert rows % rk.WARPS
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
    g = torch.randn((d,), generator=gen, device=cuda).to(dtype)
    kern = rk_ops.build(Schedule(), **rk_ops.signature_fn(x, g))
    got = kern(x, g).float()
    want = rk_ref.rmsnorm(x, g).float()
    assert kern.grid(rows) * rk.WARPS > rows
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _close(got, want, dtype):
    """Within the chip smoke's tolerance: fp32 1e-4, bf16 2e-2 (rtol and
    atol)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())


def _hoisted(prog, steps):
    order = [0, 1, 2]
    for s in range(steps):
        if s + 1 < steps:
            order += [1 + 3 * (s + 1), 2 + 3 * (s + 1)]
        order.append(3 + 3 * s)
    return tuple(order + [i for i in prog.default_order() if i not in order])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,bm,bn,bk,hoist", [
    (64, 64, 128, 8, 8, 8, False), (16, 16, 32, 16, 16, 32, False),
    (64, 64, 128, 32, 64, 16, True), (512, 512, 2048, 128, 128, 128, False),
    (512, 512, 2048, 64, 64, 64, True)])
def test_tensor_core_gemm_matches_plain(cuda, dtype, m, n, k, bm, bn, bk,
                                        hoist):
    """wgmma (bf16) and 3xTF32 mma.sync (f32) at tiles zero-filled to the
    instruction's shape and at the paper's shape, default or hoisted."""
    g = torch.Generator(device=cuda).manual_seed(m + bm)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=g, device=cuda).to(dtype)
    kern = gf.GemmKernel(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype)
    if hoist:
        kern = gf.GemmKernel(m=m, n=n, k=k, bm=bm, bn=bn, bk=bk, dtype=dtype,
                             order=_hoisted(kern.program, k // bk))
    before = gf.launches
    got = kern(x, w)
    assert gf.launches == before + 1
    assert _close(got, gf_ref.gemm_leaky_relu(x, w), dtype)


def test_gemm_tile_that_no_block_can_hold_is_rejected(cuda):
    from repro_torch.core.energy import UnassemblableSchedule
    x = torch.zeros((512, 2048), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((2048, 512), device=cuda, dtype=torch.bfloat16)
    kern = gf.GemmKernel(m=512, n=512, k=2048, bm=512, bn=512, bk=64,
                         dtype=torch.bfloat16)
    before = gf.launches
    with pytest.raises(UnassemblableSchedule):
        kern(x, w)
    assert gf.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ["v_hoisted", 1, 2])
def test_bf16_flash_matches_plain_at_reordered_loads(cuda, order, dtype):
    """bf16 within 2e-2, float32 (3xTF32) within 1e-4, at the order that
    hoists each ld_v{c} and at random legal orders."""
    from repro_torch.core import Schedule
    from repro_torch.kernels.flash_attention import ops as fa_ops
    st = dict(b=4, hq=16, hkv=8, sq=128, skv=128, d=128, causal=True,
              window=None, dtype=str(dtype).removeprefix("torch."))
    prog = fa_ops.build(Schedule(), **st).program
    if order == "v_hoisted":
        names = [ins.name for ins in prog.instrs]
        o = [i for i in prog.default_order()
             if not names[i].startswith("ld_v")]
        for c in range(2):
            o.insert(o.index(names.index(f"ld_k{c}")) + 1,
                     names.index(f"ld_v{c}"))
    else:
        o = random_legal_order(prog, order)
    kern = fa_ops.build(Schedule(order=tuple(o)), **st)
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((4, 16, 128, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((4, 8, 128, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn((4, 8, 128, 128), generator=g, device=cuda).to(dtype)
    assert _close(kern(q, k, v), fa_ref.attention(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [37, 501])
def test_padded_bidirectional_flash_matches_plain(cuda, dtype, s):
    """The model's bidirectional calls are padded to a multiple of 64 and
    pass their real key length; the kernel masks the padded keys."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((2, 4, s, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 2, s, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, 2, s, 64), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=False)
    assert fa.launches == before + 1
    assert _close(got, fa_ref.attention(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("dtype,s", [(torch.bfloat16, 4096),
                                     (torch.bfloat16, 1000),
                                     (torch.float32, 1000)])
def test_bidirectional_flash_at_the_encoder_shape(cuda, dtype, s):
    """seamless-m4t's encoder: MHA, 16 heads at head_dim 64, bidirectional,
    over its 4,096 frames (and a ragged length, padded); each row within a
    relative error of 1e-2 of the plain version, and a call with the last
    key tile zeroed outside it."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((1, 16, s, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((1, 16, s, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, 16, s, 64), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=False)
    assert fa.launches == before + 1
    want = fa_ref.attention(q, k, v, causal=False)

    def row_err(a):
        return ((a.float() - want.float()).norm(dim=-1)
                / want.float().norm(dim=-1)).max().item()
    assert row_err(got) <= 1e-2
    k0, v0 = k.clone(), v.clone()
    k0[:, :, -fa.SEQ_TILE:] = 0
    v0[:, :, -fa.SEQ_TILE:] = 0
    assert row_err(fa.flash_attention(q, k0, v0, causal=False)) > 1e-2


def test_padded_heads_prefill_on_the_kernel(cuda):
    """qwen3 at smoke width with 4 heads padded to 6: the card's prefill
    (flash over the 4 real heads) gives the CPU's logits within rtol =
    atol = 1e-4, and the paged engine the CPU's tokens."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b", padded_heads=6),
                              use_pallas=True)       # the kernels, as served
    params = M.init_lm(cfg, seed=0, device="cpu")
    on_card = M.map_params(lambda path, _: _leaf(params, path).to(cuda),
                           M.param_shapes(cfg))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 40)).astype(np.int32))
    before = fa.launches
    got, _ = M.prefill(on_card, {"tokens": toks.to(cuda)}, cfg, max_len=64)
    assert fa.launches == before + cfg.n_layers
    want, _ = M.prefill(params, {"tokens": toks}, cfg, max_len=64)
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), b)
            for n, b in ((5, 6), (45, 4), (28, 12), (5, 5))]
    scfg = ServeConfig(max_len=96, capacity=3, paged=True, page_size=16,
                       prefill_chunk=32)
    outs = []
    for p in (params, on_card):
        eng = ContinuousEngine(p, cfg, scfg)
        uids = [eng.submit(t, n).uid for t, n in reqs]
        got = eng.run(max_steps=500)
        outs.append([got[u] for u in uids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_enc_dec_engine_on_card_matches_cpu(cuda):
    """seamless-m4t at smoke width: the contiguous engine's tokens on the
    card (flash bidirectional in the encoder, causal in the decoder's
    prompt) equal the CPU's, each request with its own context."""
    from repro_torch import configs
    cfg = configs.get_smoke("seamless-m4t-large-v2")
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), b,
             {"enc_embeds": rng.standard_normal(
                 (cfg.enc_len, cfg.d_model)).astype(np.float32)})
            for n, b in ((5, 6), (11, 5), (5, 7), (8, 3))]
    scfg = ServeConfig(max_len=32, capacity=3)
    outs = []
    for device in ("cpu", cuda):
        p = M.map_params(lambda path, _: _leaf(params, path).to(device),
                         M.param_shapes(cfg))
        before = fa.launches
        eng = ContinuousEngine(p, cfg, scfg, example_extra=reqs[0][2])
        uids = [eng.submit(t, n, extra=e).uid for t, n, e in reqs]
        got = eng.run(max_steps=500)
        outs.append([got[u] for u in uids])
        assert (fa.launches > before) == (device != "cpu")
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,b,s", [(torch.bfloat16, 1, 64),
                                       (torch.bfloat16, 2, 8),
                                       (torch.float32, 2, 23)])
def test_causal_flash_at_the_decoder_prompt(cuda, dtype, b, s):
    """seamless-m4t's decoder prompt: MHA, 16 heads at head_dim 64,
    causal, one prompt and a grouped pair (a ragged length padded to 64)
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(b * s)
    q = torch.randn((b, 16, s, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, 16, s, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, 16, s, 64), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.launches == before + 1
    assert _close(got, fa_ref.attention(q, k, v, causal=True), dtype)


def _grads_on(dev, fn, arrays):
    """(output, gradients of sum(output * weights)) of ``fn`` on ``dev``,
    the inputs from ``arrays`` requiring grad."""
    ins = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
    out = fn(*ins)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(dev)
    grads = torch.autograd.grad((out.float() * w).sum(), ins)
    return out, [g.cpu() for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_under_grad_raises_and_its_plain_version_matches_cpu(cuda,
                                                                   causal):
    """The kernel has no backward: a call that autograd would record
    raises and launches nothing.  The plain version, which training runs,
    gives the CPU's gradients of q, k and v within 1e-3 of each one's
    largest |g|; without grad the kernel launches."""
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((2, h, 40, 32)).astype(np.float32)
              for h in (4, 2, 2)]
    before = fa.launches
    with pytest.raises(RuntimeError, match="no backward"):
        _grads_on(cuda, lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal), arrays)
    assert fa.launches == before

    def plain(q, k, v):
        return fa_ref.attention(q, k, v, causal=causal)
    out, got = _grads_on(cuda, plain, arrays)
    assert out.grad_fn is not None
    _, want = _grads_on("cpu", plain, arrays)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-3 * w.abs().max()
    with torch.no_grad():                 # serving launches
        fa.flash_attention(*(torch.from_numpy(a).to(cuda) for a in arrays),
                           causal=causal)
    assert fa.launches == before + 1


def test_ssd_under_grad_raises_and_its_plain_version_matches_cpu(cuda):
    """As the flash case, for ``ssd_chunked_kernel`` and the
    ``ssd_chunked_plain`` that training runs (S = 100, padded to two
    chunks of 64)."""
    gen = np.random.default_rng(0)
    arrays = [gen.standard_normal((2, 100, 4, 8)).astype(np.float32),
              np.abs(gen.standard_normal((2, 100, 4))).astype(np.float32),
              -np.abs(gen.standard_normal(4)).astype(np.float32),
              gen.standard_normal((2, 100, 16)).astype(np.float32),
              gen.standard_normal((2, 100, 16)).astype(np.float32),
              gen.standard_normal(4).astype(np.float32)]
    before = sk.launches
    with pytest.raises(RuntimeError, match="no backward"):
        _grads_on(cuda, lambda *t: sk_ops.ssd_chunked_kernel(*t, chunk=64),
                  arrays)
    assert sk.launches == before

    def plain(*t):
        return sk_ops.ssd_chunked_plain(*t, chunk=64)
    out, got = _grads_on(cuda, plain, arrays)
    assert out.grad_fn is not None
    _, want = _grads_on("cpu", plain, arrays)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-3 * w.abs().max()
    with torch.no_grad():
        sk_ops.ssd_chunked_kernel(
            *(torch.from_numpy(a).to(cuda) for a in arrays), chunk=64)
    assert sk.launches == before + 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Three float32 train steps of a smoke config from the same weights
    and batches on the card and on the CPU: losses within rtol 1e-4, the
    first step's gradients within 1e-3 of each leaf's largest |g|, and no
    kernel launched."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = configs.get_smoke(arch)
    dcfg = DataConfig(global_batch=2, seq_len=64, vocab=cfg.vocab)
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=1)
    before = (fa.launches, sk.launches)
    runs = []
    for dev in ("cpu", cuda):
        p = M.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        p = M.map_params(lambda _, t: t.to(dev), p)
        opt = adamw.init_opt_state(p)
        _, g = steps.loss_and_grads(p, batch_for_model(cfg, dcfg, 0,
                                                       device=dev), cfg=cfg)
        losses = []
        for s in range(3):
            p, opt, m = steps.train_step(
                p, opt, batch_for_model(cfg, dcfg, s, device=dev), cfg=cfg,
                opt_cfg=ocfg)
            losses.append(m["loss"].item())
        runs.append((losses, [t.cpu() for t in adamw.leaves(g)]))
    assert (fa.launches, sk.launches) == before
    (lc, gc), (lg, gg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


# ------------------------------------------------- captured decode steps
def _smoke_on(cuda, arch):
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    return cfg, M.init_lm(cfg, seed=0, device=cuda)


GRAPH_CASES = {"qwen3_paged": ("qwen3-1.7b", dict(paged=True, page_size=8,
                                                  prefill_chunk=16)),
               "qwen3_contiguous": ("qwen3-1.7b", {}),
               "mamba2": ("mamba2-2.7b", {})}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_captured_decode_equals_eager_dispatch_on_card(cuda, case):
    """The continuous engine with its decode step captured (captured under
    the sync debug mode "error": no op of the step syncs) gives the eager
    engine's tokens, and credits the gather exactly the launches the
    eager engine counts: twice a layer a decode or chunk step."""
    from repro_torch.serve import graphs
    arch, extra = GRAPH_CASES[case]
    cfg, params = _smoke_on(cuda, arch)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), b)
            for n, b in ((5, 9), (37, 6), (20, 12), (9, 5), (28, 7))]
    runs = {}
    for step_graphs in (False, True):
        before = pg.launches
        eng = ContinuousEngine(params, cfg, ServeConfig(
            max_len=64, capacity=3, step_graphs=step_graphs, **extra))
        uids = [eng.submit(t, n).uid for t, n in reqs]
        with graphs.checking_syncs():
            got = eng.run(max_steps=500)
        s = eng.stats
        runs[step_graphs] = ([got[u] for u in uids], pg.launches - before,
                             s["decode_steps"] + s["chunk_steps"])
        assert (eng.graph is not None) == step_graphs
    assert eng.graph.captures == 1 and eng.graph.pool_bytes() > 0
    (eager, eager_gathers, steps), (graph, gathers, graph_steps) = \
        runs[False], runs[True]
    for a, b in zip(eager, graph):
        np.testing.assert_array_equal(a, b)
    assert gathers == eager_gathers and steps == graph_steps
    assert gathers == (2 * cfg.n_layers * steps if extra else 0)


def test_promoted_gather_schedule_launches_on_replay(cuda):
    """A schedule committed mid-run for the decode step's gather signature
    swaps the engine, whose next decode re-captures the step: each replay
    after it adds two launches a layer to the promoted kernel's own
    count."""
    from repro_torch.core import (Schedule, ScheduleCache, SipKernel,
                                  registry, schedule_cache)
    from repro_torch.core.cache import PendingPut
    cfg, params = _smoke_on(cuda, "qwen3-1.7b")
    rng = np.random.default_rng(5)
    store = ScheduleCache()
    with schedule_cache(store):
        eng = ContinuousEngine(params, cfg, ServeConfig(
            max_len=64, capacity=3, paged=True, page_size=8))
        for n in (7, 12, 20):
            eng.submit(rng.integers(1, cfg.vocab, n).astype(np.int32), 20)
        for _ in range(3):
            eng.step()
        assert eng.graph.captures == 1
        spec = registry.spec("paged_gather")
        static = spec.signature_fn(eng.caches["k"][0],
                                   torch.as_tensor(eng._pt))
        space = spec.space_for(**static)
        sched = Schedule(knobs={k.name: k.choices[-1] for k in space.knobs})
        assert dict(sched.knobs) != space.default_knobs()
        store.commit([PendingPut(kernel_name="paged_gather",
                                 signature=SipKernel.sig_str(static),
                                 schedule=sched, energy=1e-9,
                                 tests_passed=True)])
        eng.step()                  # the swap: warm-up step, re-capture
        kern = registry.get("paged_gather", store).built(static, sched)
        assert eng.stats["schedule_swaps"] == 1 and eng.graph.captures == 2
        assert kern is not None
        for _ in range(3):
            n0 = kern.launches
            eng.step()
            assert kern.launches == n0 + 2 * cfg.n_layers


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    engine raises, and does not fall back to eager dispatch."""
    from repro_torch.serve import graphs
    cfg, params = _smoke_on(cuda, "qwen3-1.7b")
    step = graphs.M.decode_step

    def syncing(*args, **kwargs):
        logits, caches = step(*args, **kwargs)
        logits.sum().item()
        return logits, caches
    monkeypatch.setattr(graphs.M, "decode_step", syncing)
    eng = ContinuousEngine(params, cfg, ServeConfig(max_len=64, capacity=2))
    eng.submit(np.arange(1, 9, dtype=np.int32), 4)
    with pytest.raises(RuntimeError):
        eng.run(max_steps=50)
    assert eng.graph.graph is None and eng.graph.captures == 0


def test_recapturing_holds_no_more_device_memory(cuda):
    """Every capture warms up and captures on its device's one capture
    stream, so dropping and re-capturing the step holds no more memory
    (a new stream a capture held one more cuBLAS workspace, 32 MiB, for
    the life of the process)."""
    cfg, params = _smoke_on(cuda, "qwen3-1.7b")
    eng = ContinuousEngine(params, cfg, ServeConfig(max_len=64, capacity=2))
    eng.submit(np.arange(1, 9, dtype=np.int32), 12)
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        eng.graph.drop()
        eng.step()
    torch.cuda.synchronize()
    assert eng.graph.captures == 4
    assert torch.cuda.memory_allocated() - before < 2 ** 20


# ------------------------------------- captured prefill, chunk and train
#: (arch, engine settings) of the captured-prefill cases: qwen3 paged with
#: chunked prefill (prompts of 12 whole, of 20 in chunks of 16), mamba2
#: contiguous (both whole, the SSD kernel in every prefill)
PREFILL_CASES = {"qwen3_paged": ("qwen3-1.7b", dict(paged=True, page_size=8,
                                                    prefill_chunk=16)),
                 "mamba2": ("mamba2-2.7b", {})}


def _prefill_traffic(cfg, capacity: int = 2):
    """Prompts of 12 tokens, then as many of 20, 4 new tokens each: with
    ``capacity`` 2 each pair prefills as one group, so every group shape
    is sighted ``CAPTURE_AT + 1`` times (eager, captured, replayed)."""
    from repro_torch.serve.graphs import CAPTURE_AT
    rng = np.random.default_rng(6)
    n = capacity * (CAPTURE_AT + 1)
    return [(rng.integers(1, cfg.vocab, m).astype(np.int32), 4)
            for m in (12,) * n + (20,) * n]


def _served(cuda, params, cfg, reqs, **scfg):
    from repro_torch.serve import graphs
    counts = (fa.launches, pg.launches, sk.launches)
    eng = ContinuousEngine(params, cfg, ServeConfig(max_len=64, capacity=2,
                                                    **scfg))
    uids = [eng.submit(t, n).uid for t, n in reqs]
    with graphs.checking_syncs():
        got = eng.run(max_steps=500)
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(counts, (fa.launches, pg.launches,
                                                    sk.launches)))
    return eng, [got[u] for u in uids], launched


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_captured_prefill_and_chunk_equal_eager_dispatch_on_card(cuda, case):
    """Whole-prompt prefills and chunk steps captured (warm-up and capture
    under the sync debug mode "error") give the eager engine's tokens, and
    the flash, gather and SSD launches their replays credit equal the
    eager engine's counts."""
    arch, extra = PREFILL_CASES[case]
    cfg, params = _smoke_on(cuda, arch)
    reqs = _prefill_traffic(cfg)
    eager_eng, eager, eager_launches = _served(
        cuda, params, cfg, reqs, step_graphs=False, **extra)
    eng, got, launches = _served(cuda, params, cfg, reqs, **extra)
    assert eager_eng.prefill_graphs is None
    for a, b in zip(eager, got):
        np.testing.assert_array_equal(a, b)
    assert launches == eager_launches
    graphs = eng.prefill_graphs
    # one shape a kind (whole 12s and 20s, or whole 12s and 16-chunks)
    assert graphs.captures == 2 and graphs.replays > 0
    assert graphs.pool_bytes() > 0
    assert eng.stats["prefill_compiles"] == eager_eng.stats[
        "prefill_compiles"]


def test_recaptured_prefill_graphs_hold_no_more_device_memory(cuda):
    """Dropping every prefill and chunk graph (a schedule swap does) and
    capturing them again over the same traffic holds no more allocated
    memory, nor a larger shared pool."""
    cfg, params = _smoke_on(cuda, "qwen3-1.7b")
    reqs = _prefill_traffic(cfg)
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=64, capacity=2, **PREFILL_CASES["qwen3_paged"][1]))

    def serve():
        for t, n in reqs:
            eng.submit(t, n)
        eng.run(max_steps=500)
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), eng.prefill_graphs.pool_bytes()

    serve()
    before, pool = serve()
    eng._make_dispatchers()           # what a swap does
    assert not eng.prefill_graphs.steps
    after, pool_after = serve()
    assert eng.prefill_graphs.captures == 4
    assert after - before < 2 ** 20 and pool_after <= pool


def test_captured_train_steps_equal_eager_on_card(cuda, capsys):
    """Four train steps through a captured ``TrainGraph`` (warm-up and
    capture under the sync debug mode "error"; remat "full" and "dots")
    from the eager steps' weights and batches: losses within 1e-6
    relative, and the largest leaf difference printed."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.serve import graphs
    from repro_torch.train.graphs import TrainGraph

    for policy in ("full", "dots"):
        cfg = configs.get_smoke("qwen3-1.7b", remat_policy=policy)
        dcfg = DataConfig(global_batch=4, seq_len=64, vocab=cfg.vocab)
        ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=1)
        runs = []
        for captured in (False, True):
            p = M.init_lm(cfg, seed=0, device=cuda, dtype=torch.float32)
            opt = adamw.init_opt_state(p)
            if captured:
                graph = TrainGraph(p, opt, cfg=cfg, opt_cfg=ocfg,
                                   device=cuda)
            losses = []
            with graphs.checking_syncs():
                for s in range(4):
                    batch = batch_for_model(cfg, dcfg, s, device=cuda)
                    if captured:
                        m = graph.step(batch)
                    else:
                        _, _, m = steps.train_step(p, opt, batch, cfg=cfg,
                                                   opt_cfg=ocfg)
                    losses.append(m["loss"].item())
            runs.append((losses, adamw.leaves(p)))
        (le, pe), (lg, pg_) = runs
        assert graph.captures == 1 and graph.replays == 3
        np.testing.assert_allclose(lg, le, rtol=1e-6)
        worst = max(float((a - b).abs().max()) for a, b in zip(pg_, pe))
        with capsys.disabled():
            print(f"\n[train graph] remat {policy}: losses {lg} vs {le}, "
                  f"largest leaf difference {worst:.3e}")
