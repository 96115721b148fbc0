"""The port's hybrid family (Zamba-2: groups of mamba blocks, one shared
attention + MLP block) against the JAX package's, with the same weights
(moved by ``params_from_numpy``): the param tree, forward and prefill
logits, every prefill cache leaf, decode, the per-slot cache helpers, and
the serving engines' tokens.

Two configurations: the reference's own hybrid test config
(tests/test_models.py: 5 layers in groups of 2, the shared block on every
2nd group, so one group is off, one is on and one layer trails) and
zamba2-7b's smoke config (every group on, no trailing layer).  The
reference runs its jnp path except where a test names its Pallas kernels
(interpret mode).  Tolerance rtol = atol = 2e-4, as
tests/test_torch_model.py; tokens must match exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
#: tests/test_models.py's "hybrid": groups [off, on] and one trailing layer
FIELDS = dict(name="h", family="hybrid", n_layers=5, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=256, ssm_state=16,
              ssm_headdim=32, ssm_chunk=16, hybrid_group=2,
              hybrid_attn_every=2, dtype="float32")
MAX_LEN = 64


def _configs(which):
    if which == "test":
        return JConfig(**FIELDS).validate(), ModelConfig(**FIELDS).validate()
    return jconfigs.get_smoke("zamba2-7b"), tconfigs.get_smoke("zamba2-7b")


@pytest.fixture(scope="module", params=["test", "zamba2-smoke"])
def setup(request):
    jcfg, tcfg = _configs(request.param)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def test_setup():
    jcfg, tcfg = _configs("test")
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _tree_close(got, want, path=""):
    """Every leaf of ``got`` against ``want``: the same names and shapes,
    ``len`` exact, the rest within TOL."""
    assert set(got) == set(want), path
    for name in got:
        where = f"{path}/{name}"
        if isinstance(got[name], dict):
            _tree_close(got[name], want[name], where)
            continue
        assert tuple(got[name].shape) == tuple(np.shape(want[name])), where
        if name == "len":
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]), where)
        else:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), **TOL,
                                       err_msg=where)


def _paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (k,))
        else:
            yield path + (k,), tuple(np.shape(v))


def _tokens(rng, vocab, b, s):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


class TestParams:
    def test_tree_shapes_and_float32_leaves(self, setup):
        _, tcfg, jp, tp = setup
        assert dict(_paths(tp)) == dict(_paths(jp))
        n_groups, trailing = divmod(tcfg.n_layers, tcfg.hybrid_group)
        assert tp["groups"]["ln"].shape == (n_groups, tcfg.hybrid_group,
                                            tcfg.d_model)
        assert ("trailing" in tp) == bool(trailing)
        cfg = dataclasses.replace(tcfg, dtype="bfloat16")
        p = TM.init_lm(cfg, seed=0, device="cpu")
        assert dict(_paths(p)) == dict(_paths(tp))
        for path, _ in _paths(p):
            want = (torch.float32 if path[-1] in TM.F32_LEAVES
                    else torch.bfloat16)
            leaf = p
            for k in path:
                leaf = leaf[k]
            assert leaf.dtype == want, path
        attn = p["shared_attn"]["attn"]
        for name, fan in (("wq", cfg.d_model),
                          ("wo", cfg.n_heads * cfg.hd)):
            std = attn[name].float().std().item()
            assert abs(std * fan ** 0.5 - 1) < 0.1, name
        mixer = p["groups"]["mixer"]
        assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))

    def test_params_from_numpy_rejects_a_missing_or_wrong_leaf(self,
                                                               test_setup):
        _, tcfg, jp, _ = test_setup
        tree = jax.tree.map(np.asarray, jp)
        bad = dict(tree, shared_attn=dict(tree["shared_attn"]))
        del bad["shared_attn"]["ln2"]
        with pytest.raises(KeyError, match="shared_attn/ln2"):
            params_from_numpy(bad, tcfg, device="cpu")
        bad = dict(tree, trailing=dict(tree["trailing"]))
        bad["trailing"]["ln"] = bad["trailing"]["ln"][None]
        with pytest.raises(ValueError, match="trailing/ln"):
            params_from_numpy(bad, tcfg, device="cpu")


class TestForward:
    @pytest.mark.parametrize("s", [16, 37])
    def test_forward_logits(self, setup, s):
        jcfg, tcfg, jp, tp = setup
        toks = _tokens(np.random.default_rng(s), tcfg.vocab, 2, s)
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        got, _ = TM.forward(tp, {"tokens": _t(toks)}, tcfg)
        _close(got, want)

    def test_forward_against_interpret_pallas_path(self, test_setup):
        """The reference with its Pallas SSD and flash kernels (interpret
        mode) against the port's forward, which runs their plain versions
        on the CPU and launches nothing."""
        jcfg, tcfg, jp, tp = test_setup
        toks = _tokens(np.random.default_rng(7), tcfg.vocab, 1, 32)
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)},
                             dataclasses.replace(jcfg, use_pallas=True))
        before = (fa_kernel.launches, ssd_kernel.launches)
        got, _ = TM.forward(tp, {"tokens": _t(toks)}, tcfg)
        _close(got, want)
        assert (fa_kernel.launches, ssd_kernel.launches) == before

    @pytest.mark.parametrize("s", [16, 37, 3])
    def test_prefill_then_decode_steps(self, setup, s):
        """Prefill logits and every cache leaf (the off group's K/V and
        ``len`` among them), then six decode steps, leaf by leaf."""
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(s)
        toks = _tokens(rng, tcfg.vocab, 2, s)
        want, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              max_len=MAX_LEN)
        got, gc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg, max_len=MAX_LEN)
        _close(got, want)
        _tree_close(gc, wc)
        tokens = rng.integers(0, tcfg.vocab, 2).astype(np.int32)
        for _ in range(6):
            want, wc = JM.decode_step(jp, wc, jnp.asarray(tokens), jcfg)
            got, gc = TM.decode_step(tp, gc, _t(tokens), tcfg)
            _close(got, want)
            _tree_close(gc, wc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        flags = TM.hybrid_flags(tcfg)
        lens = gc["attn"]["len"].tolist()
        assert lens == [s + 6 if on else s for on in flags]


class TestSlots:
    def test_alloc_insert_evict_then_decode(self, setup):
        """Slots 3 and 1 of 4: slot 3 lies past the group-member axis (of
        size 2), so a scatter on the wrong axis of ``mamba.*`` fails."""
        jcfg, tcfg, jp, tp = setup
        toks = _tokens(np.random.default_rng(3), tcfg.vocab, 2, 9)
        ex = {"tokens": np.zeros((1, 8), np.int32)}
        jc, axes = JM.alloc_slot_caches(jp, jcfg, 4, 16, ex)
        tc = TM.alloc_slot_caches(tcfg, 4, 16, device="cpu")
        _tree_close(tc, jc)
        _, jg = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                           max_len=16)
        _, tg = TM.prefill(tp, {"tokens": _t(toks)}, tcfg, max_len=16)
        slots = np.array([3, 1], np.int32)
        jc = JM.insert_slots(jc, jg, jnp.asarray(slots), axes)
        tc = TM.insert_slots(tc, tg, _t(slots))
        _tree_close(tc, jc)
        assert tc["mamba"]["ssd"][:, :, 3].abs().sum() > 0
        jc = JM.evict_slot(jc, 3, axes)
        tc = TM.evict_slot(tc, 3)
        _tree_close(tc, jc)
        tokens = np.array([5, 6, 7, 8], np.int32)
        for _ in range(2):
            want, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
            got, tc = TM.decode_step(tp, tc, _t(tokens), tcfg)
            _close(got, want)
            _tree_close(tc, jc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)

    def test_paged_caches_and_decode_refused(self, test_setup):
        _, tcfg, _, tp = test_setup
        tc = TM.alloc_slot_caches(tcfg, 2, 16, device="cpu")
        with pytest.raises(ValueError, match="paged decode supports"):
            TM.decode_step(tp, tc, torch.zeros(2, dtype=torch.int32), tcfg,
                           pt=torch.zeros((2, 1), dtype=torch.int32))


# ============================================================ the engines
def _requests(vocab):
    """Ragged prompt lengths (the conv's minimum of 3, odd lengths, two of
    the same length, one longer than a chunk) and budgets."""
    rng = np.random.default_rng(4)
    return [(rng.integers(1, vocab, n).astype(np.int32), b)
            for n, b in ((3, 5), (17, 4), (33, 6), (9, 3), (17, 7))]


@pytest.fixture(scope="module")
def reference(test_setup):
    """repro's single-request Engine.generate — the oracle."""
    jcfg, tcfg, jp, _ = test_setup
    reqs = _requests(tcfg.vocab)
    ref = jengine.Engine(jp, jcfg, jengine.ServeConfig(max_len=MAX_LEN))
    return reqs, [ref.generate(p[None], b)[0] for p, b in reqs]


def _serve(eng, reqs, order):
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(*reqs[i]).uid: i for i in idxs}
    got = eng.run(max_steps=1000)
    return {i: got[uid] for uid, i in uid_to_idx.items()}


class TestEngines:
    def test_generate_matches_jax(self, test_setup, reference):
        _, tcfg, _, tp = test_setup
        reqs, want = reference
        eng = tengine.Engine(tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN))
        for (p, b), w in zip(reqs, want):
            np.testing.assert_array_equal(eng.generate(p[None], b)[0], w)

    @pytest.mark.parametrize("order", ["fifo", "reversed"])
    def test_contiguous_matches_jax(self, test_setup, reference, order):
        """Capacity 3 (> hybrid_group): requests land in slot 2 too."""
        jcfg, tcfg, jp, tp = test_setup
        reqs, want = reference
        scfg = dict(max_len=MAX_LEN, capacity=3)
        eng = tengine.ContinuousEngine(tp, tcfg, tengine.ServeConfig(**scfg))
        got = _serve(eng, reqs, order)
        jeng = jengine.ContinuousEngine(jp, jcfg, jengine.ServeConfig(**scfg))
        jgot = _serve(jeng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
            np.testing.assert_array_equal(got[i], jgot[i])

    def test_paged_and_short_prompts_refused_as_the_reference(self,
                                                              test_setup):
        jcfg, tcfg, jp, tp = test_setup
        for eng_mod, params, cfg in ((tengine, tp, tcfg),
                                     (jengine, jp, jcfg)):
            with pytest.raises(ValueError,
                               match=r"paged serving supports .*'hybrid'"):
                eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                    max_len=MAX_LEN, paged=True))
            eng = eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                max_len=MAX_LEN))
            with pytest.raises(ValueError, match="hybrid prompts need >= 3"):
                eng.submit(np.array([1, 2], np.int32), 2)
            assert eng.submit(np.array([1, 2, 3], np.int32), 2) is not None
