"""The port's serving engines against the JAX package's, on the same weights:
greedy ``Engine.generate`` is token-identical, and the port's paged and
contiguous ``ContinuousEngine`` reproduce ``repro``'s single-request
``Engine`` output for every request under fifo, reversed and staggered
arrival.  On the CPU no kernel launches: the plain versions run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg_kernel  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=32, d_ff=128, vocab=128, qk_norm=True,
              dtype="float32")
JCFG = JConfig(**FIELDS).validate()
CFG = ModelConfig(**FIELDS).validate()
MAX_LEN = 48


@pytest.fixture(scope="module")
def params():
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), JCFG))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                 device="cpu")


def _requests(rng, n, lo=3, hi=28, new=(2, 8)):
    reqs = [(rng.integers(1, CFG.vocab, int(rng.integers(lo, hi)))
             .astype(np.int32), int(rng.integers(*new))) for _ in range(n)]
    # one shared >1-page prefix pair in every mix
    p, b = reqs[0]
    reqs.append((np.concatenate([p[:len(p) - 1], [7, 9, 11]])
                 .astype(np.int32), b))
    return reqs


@pytest.fixture(scope="module")
def reference(params):
    """repro's single-request Engine.generate — the oracle."""
    jp, _ = params
    reqs = _requests(np.random.default_rng(0), 5)
    ref = jengine.Engine(jp, JCFG, jengine.ServeConfig(max_len=MAX_LEN))
    return reqs, [ref.generate(p[None], b)[0] for p, b in reqs]


def _serve(eng, reqs, order):
    """Submit in ``order`` ("fifo", "reversed" or "staggered": two up front,
    the rest after three steps) and run to the end -> {index: tokens}."""
    idxs = list(range(len(reqs)))
    if order == "reversed":
        idxs = idxs[::-1]
    first = idxs[:2] if order == "staggered" else idxs
    uid_to_idx = {eng.submit(*reqs[i]).uid: i for i in first}
    got = {}
    if order == "staggered":
        for _ in range(3):
            got.update({r.uid: r.output for r in eng.step()})
        uid_to_idx.update({eng.submit(*reqs[i]).uid: i for i in idxs[2:]})
    got.update(eng.run(max_steps=1000))
    return {i: got[uid] for uid, i in uid_to_idx.items()}


def _paged_cfg(**kw):
    base = dict(max_len=MAX_LEN, capacity=3, paged=True, page_size=8,
                prefill_chunk=8)
    base.update(kw)
    return tengine.ServeConfig(**base)


class TestStaticEngine:
    def test_generate_matches_jax(self, params):
        jp, tp = params
        prompts = np.random.default_rng(1).integers(1, CFG.vocab, (3, 12))
        prompts = prompts.astype(np.int32)
        want = jengine.Engine(jp, JCFG, jengine.ServeConfig(
            max_len=MAX_LEN)).generate(prompts, 9)
        eng = tengine.Engine(tp, CFG, tengine.ServeConfig(max_len=MAX_LEN))
        got = eng.generate(prompts, 9)
        np.testing.assert_array_equal(got, want)
        assert eng.stats["tokens_out"] == 27

    def test_temperature_sampling_seeded(self, params):
        _, tp = params
        prompts = np.random.default_rng(2).integers(1, CFG.vocab, (4, 8))
        prompts = prompts.astype(np.int32)
        runs = [tengine.Engine(tp, CFG, tengine.ServeConfig(
            max_len=MAX_LEN, temperature=5.0, seed=s)).generate(prompts, 6)
            for s in (0, 0, 1)]
        np.testing.assert_array_equal(runs[0], runs[1])
        assert not np.array_equal(runs[0], runs[2])


class TestContinuous:
    @pytest.mark.parametrize("order", ["fifo", "reversed", "staggered"])
    def test_paged_matches_jax(self, params, reference, order):
        _, tp = params
        reqs, want = reference
        eng = tengine.ContinuousEngine(tp, CFG, _paged_cfg())
        got = _serve(eng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
        # every page back except the prefix cache's own references
        assert eng.pages.used_pages == len(eng.prefix)
        assert eng.stats["chunk_steps"] > 0

    @pytest.mark.parametrize("capacity", [1, 3])
    @pytest.mark.parametrize("order", ["fifo", "reversed", "staggered"])
    def test_contiguous_matches_jax(self, params, reference, capacity,
                                    order):
        _, tp = params
        reqs, want = reference
        eng = tengine.ContinuousEngine(tp, CFG, tengine.ServeConfig(
            max_len=MAX_LEN, capacity=capacity))
        got = _serve(eng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")

    def test_prefix_hit_and_overflowing_final_chunk(self, params):
        """A prefix hit prefills only the tail; a zero-padded final chunk
        that overruns a full page table writes to the trash page only (the
        reference's regression case: worst = 6 pages, final chunk covers
        positions [40, 60))."""
        jp, tp = params
        rng = np.random.default_rng(3)
        base = rng.integers(1, CFG.vocab, 21).astype(np.int32)
        tail = np.concatenate([base[:20], rng.integers(1, CFG.vocab, 6)])
        ref = jengine.Engine(jp, JCFG, jengine.ServeConfig(max_len=MAX_LEN))
        eng = tengine.ContinuousEngine(tp, CFG, _paged_cfg(capacity=2))
        for p in (base, tail.astype(np.int32)):
            r = eng.submit(p, 5)
            out = eng.run(max_steps=200)
            np.testing.assert_array_equal(out[r.uid],
                                          ref.generate(p[None], 5)[0])
        assert eng.stats["prefix_hits"] == 1
        assert eng.stats["prefix_tokens_saved"] == 16

        eng = tengine.ContinuousEngine(tp, CFG, tengine.ServeConfig(
            max_len=48, capacity=1, paged=True, page_size=8,
            prefill_chunk=20, prefix_cache=False))
        prompt = np.arange(1, 46, dtype=np.int32)
        r = eng.submit(prompt, 3)
        out = eng.run(max_steps=200)
        np.testing.assert_array_equal(out[r.uid],
                                      ref.generate(prompt[None], 3)[0])
        assert eng.pages.used_pages == 0

    def test_stats_surface_and_no_launches_on_cpu(self, params, reference):
        _, tp = params
        reqs, _ = reference
        fa_kernel.launches = pg_kernel.launches = 0
        eng = tengine.ContinuousEngine(tp, CFG, _paged_cfg())
        for p, b in reqs:
            eng.submit(p, b)
        eng.run(max_steps=1000)
        assert tuple(eng.stats) == jengine._STAT_KEYS
        assert eng.stats["completed"] == len(reqs)
        assert eng.stats["schedule_swaps"] == 0
        assert eng.stats["tokens_out"] == sum(b for _, b in reqs)
        m = eng.metrics()
        assert np.isfinite(list(m.values())).all()
        assert fa_kernel.launches == 0 and pg_kernel.launches == 0

    def test_on_token_streams_every_token_in_order(self, params, reference):
        _, tp = params
        reqs, want = reference
        streamed: dict[int, list[int]] = {}
        eng = tengine.ContinuousEngine(
            tp, CFG, _paged_cfg(),
            on_token=lambda r, t: streamed.setdefault(r.uid, []).append(t))
        uids = [eng.submit(p, b).uid for p, b in reqs]
        eng.run(max_steps=1000)
        for uid, w in zip(uids, want):
            assert streamed[uid] == w.tolist()

    def test_mesh_raises(self, params):
        """A mesh the manual TP path cannot shard CFG over (2 kv heads on 4
        ranks) takes the GSPMD path, and says why; forcing the manual path
        there raises."""
        _, tp = params
        mesh = Mesh(shape={"model": 4}, rank=0, device=torch.device("cpu"),
                    backend="gloo", groups={"model": None},
                    coords={"model": 0})
        eng = tengine.ContinuousEngine(tp, CFG, mesh=mesh)
        assert eng.tp_path == "gspmd"
        assert "n_kv_heads=2 not divisible by 4" in eng.tp_reason
        with pytest.raises(ValueError, match="tp_mode='shard_map' but"):
            tengine.ContinuousEngine(tp, CFG, tengine.ServeConfig(
                tp_mode="shard_map"), mesh=mesh)


class TestAdmission:
    """The engine's admission bounds and policies, as repro's
    tests/test_serve_paged.py::TestAdmissionBounds holds them."""

    def test_contiguous_rejects_past_max_len(self, params):
        _, tp = params
        eng = tengine.ContinuousEngine(tp, CFG, tengine.ServeConfig(
            max_len=MAX_LEN))
        eng.submit(np.arange(1, 41, dtype=np.int32), 8)     # == max_len: ok
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.arange(1, 41, dtype=np.int32), 9)

    def test_paged_bound_is_the_page_table(self, params):
        jp, tp = params
        eng = tengine.ContinuousEngine(tp, CFG, tengine.ServeConfig(
            max_len=40, capacity=2, paged=True, page_size=16,
            prefill_chunk=8, prefix_cache=False))
        prompt = np.arange(1, 41, dtype=np.int32)            # 40 + 4 > max_len
        r = eng.submit(prompt, 4)                            # but <= 3 * 16
        out = eng.run(max_steps=300)
        ref = jengine.Engine(jp, JCFG, jengine.ServeConfig(max_len=48))
        np.testing.assert_array_equal(out[r.uid],
                                      ref.generate(prompt[None], 4)[0])
        with pytest.raises(ValueError, match="page table"):
            eng.submit(prompt, 9)                            # 49 > 48
        small = tengine.ContinuousEngine(tp, CFG, _paged_cfg(
            capacity=2, num_pages=4))                        # 3 usable pages
        with pytest.raises(ValueError, match="never"):
            small.submit(np.arange(1, 30, dtype=np.int32), 4)

    def test_reject_and_queue_policies(self, params):
        _, tp = params
        p = np.arange(1, 10, dtype=np.int32)
        eng = tengine.ContinuousEngine(tp, CFG, _paged_cfg(
            capacity=1, admission="reject", prefix_cache=False))
        r1 = eng.submit(p, 3)                    # queue empty: accepted
        with pytest.raises(tengine.PagesExhausted):
            eng.submit(p, 3)                     # r1 is ahead of it
        eng.run(max_steps=200)
        assert r1.done
        assert eng.submit(p, 3) is not None      # capacity is back
        eng = tengine.ContinuousEngine(tp, CFG, _paged_cfg(
            capacity=1, prefix_cache=False))
        rs = [eng.submit(p, 3) for _ in range(3)]
        eng.run(max_steps=500)
        assert all(r.done for r in rs)
        with pytest.raises(ValueError, match="admission"):
            tengine.ContinuousEngine(tp, CFG, _paged_cfg(admission="drop"))


# ===================================================== mamba2 (ssm family)
SSM_FIELDS = dict(name="m", family="ssm", n_layers=2, d_model=64, n_heads=0,
                  n_kv_heads=0, d_ff=0, vocab=128, ssm_state=16,
                  ssm_headdim=32, ssm_chunk=16, dtype="float32")
SSM_JCFG = JConfig(**SSM_FIELDS).validate()
SSM_CFG = ModelConfig(**SSM_FIELDS).validate()


@pytest.fixture(scope="module")
def ssm_params():
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(1), SSM_JCFG))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), SSM_CFG,
                                 device="cpu")


@pytest.fixture(scope="module")
def ssm_reference(ssm_params):
    """repro's single-request Engine.generate over ragged prompt lengths,
    odd ones and a whole chunk among them."""
    jp, _ = ssm_params
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(1, SSM_CFG.vocab, n).astype(np.int32), b)
            for n, b in ((3, 5), (17, 4), (32, 6), (9, 3), (17, 7), (25, 2))]
    ref = jengine.Engine(jp, SSM_JCFG, jengine.ServeConfig(max_len=MAX_LEN))
    return reqs, [ref.generate(p[None], b)[0] for p, b in reqs]


class TestMambaServing:
    def test_generate_matches_jax(self, ssm_params, ssm_reference):
        _, tp = ssm_params
        reqs, want = ssm_reference
        eng = tengine.Engine(tp, SSM_CFG, tengine.ServeConfig(max_len=MAX_LEN))
        for (p, b), w in zip(reqs, want):
            np.testing.assert_array_equal(eng.generate(p[None], b)[0], w)

    @pytest.mark.parametrize("capacity", [1, 3])
    @pytest.mark.parametrize("order", ["fifo", "reversed", "staggered"])
    def test_contiguous_matches_jax(self, ssm_params, ssm_reference, capacity,
                                    order):
        jp, tp = ssm_params
        reqs, want = ssm_reference
        eng = tengine.ContinuousEngine(tp, SSM_CFG, tengine.ServeConfig(
            max_len=MAX_LEN, capacity=capacity))
        got = _serve(eng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
        # the reference's continuous engine gives the same tokens
        jeng = jengine.ContinuousEngine(jp, SSM_JCFG, jengine.ServeConfig(
            max_len=MAX_LEN, capacity=capacity))
        jgot = _serve(jeng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], jgot[i])

    def test_paged_and_short_prompts_refused_as_the_reference(self,
                                                              ssm_params):
        jp, tp = ssm_params
        for eng_mod, params, cfg in ((tengine, tp, SSM_CFG),
                                     (jengine, jp, SSM_JCFG)):
            with pytest.raises(ValueError,
                               match=r"paged serving supports .*'ssm'"):
                eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                    max_len=MAX_LEN, paged=True))
            eng = eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                max_len=MAX_LEN))
            with pytest.raises(ValueError, match="ssm prompts need >= 3"):
                eng.submit(np.array([1, 2], np.int32), 2)
            assert eng.submit(np.array([1, 2, 3], np.int32), 2) is not None
