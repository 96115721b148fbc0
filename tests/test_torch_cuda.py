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
sliding-window runs on the card token-identical to the same runs on the
CPU, the MoE layer on the card against the CPU and bitwise repeatable,
and an autotune promotion on the card that the running engine swaps to
and launches.  Marked ``cuda``: they skip without a card.  On the GPU
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
