"""The port's dense model against the JAX package's, on the qwen3-1.7b smoke
config with the same weights (moved by ``params_from_numpy``): logits from
forward, prefill, per-slot contiguous decode and paged decode/chunked
prefill, and the caches leaf by leaf.  JAX runs with ``use_pallas=True``
(its Pallas kernels in interpret mode on the CPU).  Tolerance rtol = atol =
2e-4, as tests/test_serve.py holds the Pallas path to the jnp one."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), use_pallas=True)
    tcfg = tconfigs.get_smoke(ARCH)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _t(v) for k, v in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _caches_close(got, want):
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(np.shape(want[name])), name
        if name == "len":
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        else:
            _close(got[name], want[name])


class TestConfigs:
    def test_same_values_as_jax(self):
        for name in jconfigs.arch_names():
            assert dataclasses.asdict(tconfigs.get(name)) == \
                dataclasses.asdict(jconfigs.get(name))
            assert dataclasses.asdict(tconfigs.get_smoke(name)) == \
                dataclasses.asdict(jconfigs.get_smoke(name))

    @pytest.mark.parametrize("name", ["seamless-m4t-large-v2"])
    def test_unsupported_raise(self, name):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.init_lm(tconfigs.get_smoke(name), device="cpu")

    @pytest.mark.parametrize("name", ["llama4-scout-17b-16e",
                                      "llava-next-34b", "dbrx-132b"])
    def test_moe_and_vlm_init(self, name):
        """The reference's param tree, leaf for leaf, with its init scales;
        in bf16 an MoE router and the norm gains stay float32."""
        cfg = tconfigs.get_smoke(name, dtype="bfloat16")
        tp = TM.init_lm(cfg, seed=0, device="cpu")
        want = JM.init_lm_shapes(jax.random.PRNGKey(0),
                                 jconfigs.get_smoke(name))
        want = {"/".join(str(k.key) for k in path): tuple(leaf.value.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=jnn.is_param)[0]}
        got = {}

        def walk(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    got["/".join(path + (k,))] = v
        walk(tp)
        assert {k: tuple(v.shape) for k, v in got.items()} == want
        for path, leaf in got.items():
            name_ = path.split("/")[-1]
            f32 = name_ in TM.F32_LEAVES
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16)
            if name_ in TM.NORM_LEAVES:
                assert torch.equal(leaf, torch.ones_like(leaf))
        ffn = tp["blocks"]["ffn"]
        if cfg.family == "moe":
            for leaf, fan_in in (("router", cfg.d_model),
                                 ("w_gate", cfg.d_model),
                                 ("w_down", cfg.d_ff)):
                std = ffn[leaf].float().std().item()
                assert abs(std * fan_in ** 0.5 - 1) < 0.05, leaf

    def test_init_draws_small_leaves_whole(self):
        """Below ``DRAW_WHOLE`` elements a leaf is one draw of the seed's
        stream, in tree order: the values earlier releases gave."""
        cfg = tconfigs.get_smoke(ARCH)
        tp = TM.init_lm(cfg, seed=3, device="cpu")
        gen = torch.Generator().manual_seed(3)
        assert torch.equal(tp["embed"],
                           torch.randn(tuple(tp["embed"].shape),
                                       generator=gen))

    def test_init_draws_large_stacked_leaves_by_slice(self, monkeypatch):
        """Past ``DRAW_WHOLE`` a stacked leaf is drawn one slice of its
        leading axes at a time (the moe experts' (layer, expert) slices),
        in the stored dtype; 2-D leaves stay whole."""
        cfg = tconfigs.get_smoke("dbrx-132b", dtype="bfloat16")
        randn, draws = torch.randn, []

        def counting(shape, **kw):
            draws.append(tuple(shape))
            return randn(shape, **kw)
        monkeypatch.setattr(torch, "randn", counting)
        TM.init_lm(cfg, seed=0, device="cpu")
        whole = list(draws)
        assert (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff) in whole
        draws.clear()
        monkeypatch.setattr(TM, "DRAW_WHOLE", 0)
        sliced = TM.init_lm(cfg, seed=0, device="cpu")
        assert draws.count((cfg.d_model, cfg.d_ff)) == \
            2 * cfg.n_layers * cfg.n_experts              # w_gate, w_up
        assert draws.count((cfg.vocab, cfg.d_model)) == 1  # embed, whole
        assert len(draws) > len(whole)
        w = sliced["blocks"]["ffn"]["w_gate"]
        assert w.dtype == torch.bfloat16
        std = w.float().std(dim=(-2, -1)) * cfg.d_model ** 0.5
        assert std.shape == (cfg.n_layers, cfg.n_experts)
        assert bool(((std - 1).abs() < 0.05).all())

    def test_padded_heads_raise(self):
        cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), padded_heads=8)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.init_lm(cfg, device="cpu")


class TestForward:
    @pytest.mark.parametrize("s", [16, 13])
    def test_forward_logits(self, setup, s):
        jcfg, tcfg, jp, tp = setup
        toks = np.random.default_rng(s).integers(0, tcfg.vocab, (2, s))
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jcfg)
        got, _ = TM.forward(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg)
        _close(got, want)

    def test_prefill_logits_and_caches(self, setup):
        jcfg, tcfg, jp, tp = setup
        toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 16))
        want, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                              jcfg, max_len=40)
        got, gc = TM.prefill(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg,
                             max_len=40)
        _close(got, want)
        _caches_close(gc, wc)

    def test_params_from_numpy_rejects_wrong_shapes(self, setup):
        _, tcfg, jp, _ = setup
        tree = jax.tree.map(np.asarray, jp)
        tree["embed"] = tree["embed"][:, :-1]
        with pytest.raises(ValueError, match="embed"):
            params_from_numpy(tree, tcfg, device="cpu")


def _slot_caches(jcfg, jp, capacity, max_len, prompts):
    """JAX per-slot caches with ``prompts`` (slot -> tokens) inserted."""
    ex = {"tokens": np.zeros((1, 8), np.int32)}
    caches, axes = JM.alloc_slot_caches(jp, jcfg, capacity, max_len, ex)
    for slot, toks in prompts.items():
        _, grp = JM.prefill(jp, {"tokens": jnp.asarray(toks[None])}, jcfg,
                            max_len=max_len)
        caches = JM.insert_slot(caches, grp, slot, axes)
    return caches


class TestContiguousDecode:
    def test_decode_step_per_slot(self, setup):
        """Three slots at their own offsets, one of them never filled."""
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(2)
        prompts = {0: rng.integers(0, tcfg.vocab, 16).astype(np.int32),
                   2: rng.integers(0, tcfg.vocab, 9).astype(np.int32)}
        jc = _slot_caches(jcfg, jp, 3, 32, prompts)
        tc = _tree_t(jc)
        tokens = rng.integers(0, tcfg.vocab, 3).astype(np.int32)
        for _ in range(2):
            want, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
            got, tc = TM.decode_step(tp, tc, _t(tokens), tcfg)
            _close(got, want)
            _caches_close(tc, jc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)

    def test_slot_helpers_match(self, setup):
        jcfg, tcfg, jp, tp = setup
        toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 8))
        ex = {"tokens": np.zeros((1, 8), np.int32)}
        jc, axes = JM.alloc_slot_caches(jp, jcfg, 4, 16, ex)
        tc = TM.alloc_slot_caches(tcfg, 4, 16, device="cpu")
        _caches_close(tc, jc)
        _, jg = JM.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                           max_len=16)
        _, tg = TM.prefill(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg,
                           max_len=16)
        slots = np.array([3, 1], np.int32)
        jc = JM.insert_slots(jc, jg, jnp.asarray(slots), axes)
        tc = TM.insert_slots(tc, tg, _t(slots))
        _caches_close(tc, jc)
        jc = JM.evict_slot(jc, 3, axes)
        tc = TM.evict_slot(tc, 3)
        _caches_close(tc, jc)


class TestPagedDecode:
    PS, N_PAGES, CAP = 8, 6, 3

    def _paged(self, setup):
        """JAX paged caches: slot 0 holds a 13-token prompt in pages [1, 2],
        slot 1 a 21-token prompt in pages [7, 8, 9]; slot 2 is idle."""
        jcfg, tcfg, jp, _ = setup
        ps, n = self.PS, self.N_PAGES
        ex = {"tokens": np.zeros((1, 8), np.int32)}
        caches, axes = JM.alloc_paged_caches(
            jp, jcfg, self.CAP, n * ps, ps, self.CAP * n + 1, ex)
        rng = np.random.default_rng(4)
        for slot, plen, pages in ((0, 13, [1, 2]), (1, 21, [7, 8, 9])):
            toks = rng.integers(0, tcfg.vocab, (1, plen)).astype(np.int32)
            _, grp = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                max_len=len(pages) * ps)
            caches = JM.insert_pages(caches, grp, jnp.asarray([slot]),
                                     jnp.asarray([pages], jnp.int32), axes)
        pt = np.zeros((self.CAP, n), np.int32)
        pt[0] = [1, 2, 3, 4, 5, 6]
        pt[1] = [7, 8, 9, 10, 11, 12]
        return caches, axes, pt

    def test_alloc_and_insert_match(self, setup):
        jcfg, tcfg, jp, tp = setup
        jc, _, _ = self._paged(setup)
        tc = TM.alloc_paged_caches(tcfg, self.CAP, self.PS,
                                   self.CAP * self.N_PAGES + 1, device="cpu")
        rng = np.random.default_rng(4)
        for slot, plen, pages in ((0, 13, [1, 2]), (1, 21, [7, 8, 9])):
            toks = rng.integers(0, tcfg.vocab, (1, plen)).astype(np.int32)
            _, grp = TM.prefill(tp, {"tokens": _t(toks)}, tcfg,
                                max_len=len(pages) * self.PS)
            tc = TM.insert_pages(tc, grp, torch.tensor([slot]),
                                 torch.tensor([pages], dtype=torch.int32))
        _caches_close(tc, jc)

    def test_decode_step_paged_with_active(self, setup):
        jcfg, tcfg, jp, tp = setup
        jc, _, pt = self._paged(setup)
        tc = _tree_t(jc)
        active = np.array([True, True, False])
        tokens = np.array([5, 17, 3], np.int32)
        for _ in range(2):
            want, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg,
                                      pt=jnp.asarray(pt),
                                      active=jnp.asarray(active))
            got, tc = TM.decode_step(tp, tc, _t(tokens), tcfg, pt=_t(pt),
                                     active=_t(active))
            _close(got[:2], want[:2])
            _caches_close(tc, jc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)

    @pytest.mark.parametrize("start,chunk,n_valid", [
        (0, 8, 8),        # a full first chunk
        (16, 16, 11),     # a padded final chunk
        (40, 16, 8),      # padding overruns the 48-position table: trash page
    ])
    def test_prefill_chunk(self, setup, start, chunk, n_valid):
        jcfg, tcfg, jp, tp = setup
        jc, axes, pt = self._paged(setup)
        pt[2] = [13, 14, 15, 16, 17, 18]
        jc = JM.set_slot_lens(jc, 2, jnp.int32(start), axes)
        tc = TM.set_slot_lens(_tree_t(jc), 2, start)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :n_valid] = np.random.default_rng(5).integers(0, tcfg.vocab,
                                                             n_valid)
        want, jc = JM.prefill_chunk(jp, jc, jnp.asarray(buf),
                                    jnp.asarray(pt[2:3]), jnp.int32(2),
                                    jnp.int32(n_valid), jcfg, axes)
        got, tc = TM.prefill_chunk(tp, tc, _t(buf), _t(pt[2:3]), 2, n_valid,
                                   tcfg)
        _close(got, want)
        _caches_close(tc, jc)
        assert int(tc["len"][0, 2]) == start + n_valid

    def test_decode_tokens_n_valid(self, setup):
        """decode_tokens on the whole batch with pt, active and n_valid."""
        jcfg, tcfg, jp, tp = setup
        jc, _, pt = self._paged(setup)
        tc = _tree_t(jc)
        toks = np.random.default_rng(6).integers(0, tcfg.vocab, (3, 4))
        active = np.array([True, False, True])
        want, jc = JM.decode_tokens(jp, jc, jnp.asarray(toks, jnp.int32),
                                    jcfg, pt=jnp.asarray(pt),
                                    active=jnp.asarray(active),
                                    n_valid=jnp.int32(3))
        got, tc = TM.decode_tokens(tp, tc, _t(toks.astype(np.int32)), tcfg,
                                   pt=_t(pt), active=_t(active), n_valid=3)
        _close(got[active], np.asarray(want)[active])
        # page 0 takes every inactive or padded write; which duplicate wins
        # is unspecified in both packages
        got_c = {k: (v[:, 1:] if k != "len" else v) for k, v in tc.items()}
        want_c = {k: (np.asarray(v)[:, 1:] if k != "len" else v)
                  for k, v in jc.items()}
        _caches_close(got_c, want_c)


def test_init_lm_cpu_shapes():
    cfg = tconfigs.get_smoke(ARCH)
    p = TM.init_lm(cfg, seed=0, device="cpu")
    assert p["blocks"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads, cfg.hd)
    assert p["ln_f"].dtype == torch.float32
    logits, _ = TM.forward(p, {"tokens": torch.zeros((1, 5), dtype=torch.int32)},
                           cfg)
    assert logits.shape == (1, 5, cfg.vocab)
    assert torch.isfinite(logits).all()


# ===================================================== mamba2 (ssm family)
SSM_ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def ssm_setup():
    """mamba2's smoke config (4 layers, d 128, state 16, chunk 16) with the
    reference's weights.  The reference runs its jnp SSD path
    (``use_pallas=False``): at ragged lengths its Pallas path takes chunks
    of 1, and the kernel is held to the interpret-mode Pallas kernel in
    tests/test_torch_ssd.py."""
    jcfg = jconfigs.get_smoke(SSM_ARCH)
    tcfg = tconfigs.get_smoke(SSM_ARCH)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


class TestMamba:
    def test_params_keep_reference_tree_and_float32_leaves(self, ssm_setup):
        _, tcfg, jp, tp = ssm_setup
        assert set(tp["blocks"]["mixer"]) == set(jp["blocks"]["mixer"])
        for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
            assert tp["blocks"]["mixer"][name].dtype == torch.float32
        cfg = dataclasses.replace(tcfg, dtype="bfloat16")
        p = TM.init_lm(cfg, seed=0, device="cpu")
        mixer = p["blocks"]["mixer"]
        assert mixer["in_proj"].dtype == torch.bfloat16
        assert mixer["A_log"].dtype == torch.float32
        assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))
        assert torch.equal(mixer["dt_bias"], torch.zeros_like(mixer["dt_bias"]))
        for name, fan in (("in_proj", cfg.d_model),
                          ("conv_w", cfg.conv_width),
                          ("out_proj", cfg.d_inner)):
            std = mixer[name].float().std().item()
            assert abs(std * fan ** 0.5 - 1) < 0.1, name

    @pytest.mark.parametrize("s", [32, 13, 37])
    def test_forward_logits(self, ssm_setup, s):
        jcfg, tcfg, jp, tp = ssm_setup
        toks = np.random.default_rng(s).integers(0, tcfg.vocab, (2, s))
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jcfg)
        got, _ = TM.forward(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg)
        _close(got, want)

    def test_forward_against_interpret_pallas_path(self, ssm_setup):
        jcfg, tcfg, jp, tp = ssm_setup
        toks = np.random.default_rng(7).integers(0, tcfg.vocab, (1, 32))
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             dataclasses.replace(jcfg, use_pallas=True))
        got, _ = TM.forward(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg)
        _close(got, want)

    @pytest.mark.parametrize("s", [16, 19, 3])
    def test_prefill_then_decode_steps(self, ssm_setup, s):
        """Logits and the conv/SSD states after prefill and after each of
        three decode steps."""
        jcfg, tcfg, jp, tp = ssm_setup
        rng = np.random.default_rng(s)
        toks = rng.integers(0, tcfg.vocab, (2, s)).astype(np.int32)
        want, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              max_len=64)
        got, gc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg, max_len=64)
        _close(got, want)
        _caches_close(gc, wc)
        assert gc["conv"].dtype == torch.float32 and set(gc) == {"conv",
                                                                 "ssd"}
        tokens = rng.integers(0, tcfg.vocab, 2).astype(np.int32)
        for _ in range(3):
            want, wc = JM.decode_step(jp, wc, jnp.asarray(tokens), jcfg)
            got, gc = TM.decode_step(tp, gc, _t(tokens), tcfg)
            _close(got, want)
            _caches_close(gc, wc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)

    def test_slot_caches_insert_and_evict(self, ssm_setup):
        jcfg, tcfg, jp, tp = ssm_setup
        toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 9))
        ex = {"tokens": np.zeros((1, 8), np.int32)}
        jc, axes = JM.alloc_slot_caches(jp, jcfg, 4, 16, ex)
        tc = TM.alloc_slot_caches(tcfg, 4, 16, device="cpu")
        _caches_close(tc, jc)
        _, jg = JM.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                           max_len=16)
        _, tg = TM.prefill(tp, {"tokens": _t(toks.astype(np.int32))}, tcfg,
                           max_len=16)
        slots = np.array([3, 1], np.int32)
        jc = JM.insert_slots(jc, jg, jnp.asarray(slots), axes)
        tc = TM.insert_slots(tc, tg, _t(slots))
        _caches_close(tc, jc)
        jc = JM.evict_slot(jc, 3, axes)
        tc = TM.evict_slot(tc, 3)
        _caches_close(tc, jc)
        tokens = np.array([5, 6, 7, 8], np.int32)
        want, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
        got, tc = TM.decode_step(tp, tc, _t(tokens), tcfg)
        _close(got, want)
        _caches_close(tc, jc)

    @pytest.mark.parametrize("s", [5, 37])
    def test_mixer_continues_from_a_state(self, ssm_setup, s):
        """A continuation of S > 1 from a prefill's state runs the padded
        chunked SSD (the reference: its largest power-of-two chunk); the
        output and both states agree at the logits tolerance."""
        from repro.models import ssm as jssm
        from repro_torch.models import ssm as tssm
        jcfg, tcfg, jp, tp = ssm_setup
        jmix = {k: v[0] for k, v in jp["blocks"]["mixer"].items()}
        tmix = {k: v[0] for k, v in tp["blocks"]["mixer"].items()}
        rng = np.random.default_rng(s)
        x0, x1 = (rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)
                  for n in (19, s))
        _, jst = jssm.mamba(jmix, jnp.asarray(x0), jcfg, return_state=True)
        _, tst = tssm.mamba(tmix, _t(x0), tcfg, return_state=True)
        want, jst = jssm.mamba(jmix, jnp.asarray(x1), jcfg, state=jst)
        got, tst = tssm.mamba(tmix, _t(x1), tcfg, state=tst)
        _close(got, want)
        _caches_close(tst, jst)

    def test_paged_decode_refused(self, ssm_setup):
        _, tcfg, _, tp = ssm_setup
        tc = TM.alloc_slot_caches(tcfg, 2, 16, device="cpu")
        with pytest.raises(ValueError, match="paged decode supports"):
            TM.decode_step(tp, tc, torch.zeros(2, dtype=torch.int32), tcfg,
                           pt=torch.zeros((2, 1), dtype=torch.int32))
