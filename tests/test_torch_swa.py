"""The port's sliding-window attention against the JAX package's, with the
same weights (moved by ``params_from_numpy``): forward and prefill logits,
the ring-buffer caches a prefill shorter than, as long as and longer than
the window leaves, decode that wraps the ring (one sequence and per slot,
with ``max_len`` above and below the window), and the serving engines'
tokens with prompts longer than the window and decodes that wrap.

Two configurations: h2o-danube-1.8b's smoke config (window 32) and
tests/test_models.py's ``dense_swa`` (window 16).  Tolerance rtol = atol =
2e-4, as tests/test_torch_model.py; tokens must match exactly."""

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
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
#: tests/test_models.py's "dense_swa"
FIELDS = dict(name="swa", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=256, window=16, dtype="float32")


def _configs(which):
    if which == "dense_swa":
        return JConfig(**FIELDS).validate(), ModelConfig(**FIELDS).validate()
    return (jconfigs.get_smoke("h2o-danube-1.8b"),
            tconfigs.get_smoke("h2o-danube-1.8b"))


def _load(which):
    jcfg, tcfg = _configs(which)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["danube-smoke", "dense_swa"])
def setup(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def swa_setup():
    return _load("dense_swa")


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _t(v) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _caches_close(got, want):
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(np.shape(want[name])), name
        if name == "len":
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        else:
            _close(got[name], want[name])


def _tokens(rng, vocab, shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


class TestPrefill:
    def test_forward_logits_past_the_window(self, setup):
        jcfg, tcfg, jp, tp = setup
        toks = _tokens(np.random.default_rng(0), tcfg.vocab,
                       (2, tcfg.window + 21))
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        got, _ = TM.forward(tp, {"tokens": _t(toks)}, tcfg)
        _close(got, want)

    @pytest.mark.parametrize("past", [-7, 0, 21])
    def test_prefill_logits_and_ring(self, setup, past):
        """A prompt of window + ``past`` tokens: the cache holds the
        window, a longer prompt's last positions rolled to p % window."""
        jcfg, tcfg, jp, tp = setup
        s = tcfg.window + past
        toks = _tokens(np.random.default_rng(s), tcfg.vocab, (2, s))
        want, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              max_len=4 * tcfg.window)
        got, gc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg,
                             max_len=4 * tcfg.window)
        assert gc["k"].shape[2] == tcfg.window
        _close(got, want)
        _caches_close(gc, wc)

    def test_decode_wraps_the_ring(self, setup):
        """A prompt 5 short of the window, then 12 decode steps: the ring
        wraps at step 6."""
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(1)
        toks = _tokens(rng, tcfg.vocab, (2, tcfg.window - 5))
        want, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              max_len=4 * tcfg.window)
        got, gc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg,
                             max_len=4 * tcfg.window)
        tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        for _ in range(12):
            want, wc = JM.decode_step(jp, wc, jnp.asarray(tokens), jcfg)
            got, gc = TM.decode_step(tp, gc, _t(tokens), tcfg)
            _close(got, want)
            _caches_close(gc, wc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        assert int(gc["len"][0]) == tcfg.window + 7


class TestSlots:
    @pytest.mark.parametrize("below", [False, True])
    def test_per_slot_decode_at_mixed_positions(self, swa_setup, below):
        """Three slots of a four-slot cache: a short prompt, one as long as
        the ring and one past the window, decoding 8 steps together (slot
        2 never filled).  ``max_len`` is 48 (above the window of 16: the
        ring is the window) or 12 (below it: the ring is max_len)."""
        jcfg, tcfg, jp, tp = swa_setup
        max_len = 12 if below else 48
        m = TM.kv_cache_len(tcfg, max_len)
        rng = np.random.default_rng(5)
        prompts = {0: 5, 1: m, 3: 21}
        ex = {"tokens": np.zeros((1, 8), np.int32)}
        jc, axes = JM.alloc_slot_caches(jp, jcfg, 4, max_len, ex)
        tc = TM.alloc_slot_caches(tcfg, 4, max_len, device="cpu")
        _caches_close(tc, jc)
        for slot, n in prompts.items():
            toks = _tokens(rng, tcfg.vocab, (1, n))
            _, jg = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                               max_len=max_len)
            _, tg = TM.prefill(tp, {"tokens": _t(toks)}, tcfg,
                               max_len=max_len)
            _caches_close(tg, jg)
            jc = JM.insert_slot(jc, jg, slot, axes)
            tc = TM.insert_slots(tc, tg, torch.tensor([slot]))
        _caches_close(tc, jc)
        tokens = _tokens(rng, tcfg.vocab, 4)
        for _ in range(8):
            want, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
            got, tc = TM.decode_step(tp, tc, _t(tokens), tcfg)
            _close(got, want)
            _caches_close(tc, jc)
            tokens = np.asarray(jnp.argmax(want, axis=-1), np.int32)

    def test_paged_caches_refused(self, swa_setup):
        jcfg, tcfg, jp, tp = swa_setup
        with pytest.raises(ValueError, match="sliding-window"):
            TM.alloc_paged_caches(tcfg, 2, 8, 9, device="cpu")
        for eng_mod, params, cfg in ((tengine, tp, tcfg),
                                     (jengine, jp, jcfg)):
            with pytest.raises(ValueError, match="sliding-window"):
                eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                    max_len=48, paged=True))


# ============================================================ the engines
MAX_LEN = 48
#: (prompt length, budget): two past the window of 16, one that wraps the
#: ring during decode (12 + 10), one that stays inside it
REQUESTS = ((5, 6), (21, 4), (12, 10), (30, 3), (9, 7))


@pytest.fixture(scope="module")
def reference(swa_setup):
    """repro's single-request Engine.generate — the oracle."""
    jcfg, tcfg, jp, _ = swa_setup
    rng = np.random.default_rng(6)
    reqs = [(_tokens(rng, tcfg.vocab, n), b) for n, b in REQUESTS]
    ref = jengine.Engine(jp, jcfg, jengine.ServeConfig(max_len=MAX_LEN))
    return reqs, [ref.generate(p[None], b)[0] for p, b in reqs]


def _serve(eng, reqs, order):
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(*reqs[i]).uid: i for i in idxs}
    got = eng.run(max_steps=1000)
    return {i: got[uid] for uid, i in uid_to_idx.items()}


class TestEngines:
    def test_generate_matches_jax(self, swa_setup, reference):
        _, tcfg, _, tp = swa_setup
        reqs, want = reference
        eng = tengine.Engine(tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN))
        for (p, b), w in zip(reqs, want):
            np.testing.assert_array_equal(eng.generate(p[None], b)[0], w)

    @pytest.mark.parametrize("order", ["fifo", "reversed"])
    def test_contiguous_matches_jax(self, swa_setup, reference, order):
        jcfg, tcfg, jp, tp = swa_setup
        reqs, want = reference
        scfg = dict(max_len=MAX_LEN, capacity=3)
        eng = tengine.ContinuousEngine(tp, tcfg, tengine.ServeConfig(**scfg))
        assert eng.caches["k"].shape[2] == tcfg.window
        got = _serve(eng, reqs, order)
        jeng = jengine.ContinuousEngine(jp, jcfg, jengine.ServeConfig(**scfg))
        jgot = _serve(jeng, reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
            np.testing.assert_array_equal(got[i], jgot[i])
