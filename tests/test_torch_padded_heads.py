"""Padded heads in the port against the JAX package: a config whose query
heads are padded (``padded_heads``) with zeroed ``wq``/``wo`` slices
computes the unpadded model's function.  ``repro``'s own checks
(tests/test_perf_levers.py, ``TestPaddedHeads``) made differential: the
padded forward against the same weights with the padded slices cut away,
decode against forward, the head layouts (the reference's q-head ->
kv-head map, at 40 heads on 8 padded to 48) and the paged and contiguous
engines' tokens against ``repro``'s engines on a padded qwen3 smoke
config.  The training-gradient check waits for a training port.

Float32.  Padded against sliced: rtol = atol = 1e-4, as the reference's
check; port against ``repro``: rtol = atol = 2e-4, as
tests/test_torch_model.py; tokens must match exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SLICED_TOL = dict(rtol=1e-4, atol=1e-4)
#: the reference's TestPaddedHeads config: 5 heads on one kv head, padded
#: to 8
BASE = dict(name="p", family="dense", n_layers=2, d_model=64, n_heads=5,
            n_kv_heads=1, head_dim=16, d_ff=128, vocab=128, dtype="float32")


def _pair(**kw):
    """(repro config, port config, repro params, port params)."""
    jcfg = JModelConfig(**{**BASE, **kw})
    tcfg = ModelConfig(**{**BASE, **kw})
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def padded():
    return _pair(padded_heads=8)


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _toks(cfg, b=2, s=16, seed=11):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _sliced(tp, n_heads):
    """The port's params with the padded heads' slices cut away."""
    attn = dict(tp["blocks"]["attn"])
    attn["wq"] = attn["wq"][:, :, :n_heads].contiguous()
    attn["wo"] = attn["wo"][:, :n_heads].contiguous()
    return {**tp, "blocks": {**tp["blocks"], "attn": attn}}


class TestPaddedHeads:
    def test_param_tree_holds_the_padded_heads(self, padded):
        jcfg, tcfg, jp, tp = padded
        attn = tp["blocks"]["attn"]
        assert tuple(attn["wq"].shape) == (2, 64, 8, 16)
        assert tuple(attn["wo"].shape) == (2, 8, 16, 64)
        assert tattn.phys_heads(tcfg) == jattn.phys_heads(jcfg) == 8
        # the port's own init zeroes the padded slices, as the reference's
        own = TM.init_lm(tcfg, seed=0, device="cpu")["blocks"]["attn"]
        assert not own["wq"][:, :, 5:].any() and not own["wo"][:, 5:].any()
        assert own["wq"][:, :, :5].all() and own["wo"][:, :5].all()

    def test_padded_forward_equals_sliced_and_reference(self, padded):
        """Zero-padded heads contribute nothing: slicing them away gives
        the same logits, and both equal the reference's padded forward."""
        jcfg, tcfg, jp, tp = padded
        toks = _toks(tcfg)
        got, _ = TM.forward(tp, {"tokens": _t(toks)}, tcfg)
        unpadded = dataclasses.replace(tcfg, padded_heads=0)
        sliced, _ = TM.forward(_sliced(tp, 5), {"tokens": _t(toks)},
                               unpadded)
        np.testing.assert_allclose(got.numpy(), sliced.numpy(),
                                   **SLICED_TOL)
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_padded_decode_parity(self, padded):
        """Prefill then one decode step gives forward's last logits, and
        the reference's."""
        jcfg, tcfg, jp, tp = padded
        t = _toks(tcfg)
        full, _ = TM.forward(tp, {"tokens": _t(t)}, tcfg)
        _, caches = TM.prefill(tp, {"tokens": _t(t[:, :-1])}, tcfg,
                               max_len=20)
        got, _ = TM.decode_step(tp, caches, _t(t[:, -1]), tcfg)
        np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
        _, jc = JM.prefill(jp, {"tokens": jnp.asarray(t[:, :-1])}, jcfg,
                           max_len=20)
        want, _ = JM.decode_step(jp, jc, jnp.asarray(t[:, -1]), jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("n_heads,n_kv,padded_heads",
                             [(40, 8, 48), (5, 1, 8), (4, 2, 0)])
    def test_head_layouts_match_the_reference(self, n_heads, n_kv,
                                              padded_heads):
        """At 40 heads on 8 kv heads padded to 48 the reference maps the
        real heads i -> i // 5 and the padded ones to kv 0 (its
        ``kv_head_map``); the port groups the first 40 heads as its
        kernel does and drops the rest.  Forward and a decode step after
        prefill give the reference's logits at each layout."""
        jcfg, tcfg, jp, tp = _pair(n_layers=1, n_heads=n_heads,
                                   n_kv_heads=n_kv, head_dim=8,
                                   padded_heads=padded_heads)
        if padded_heads:
            hmap = np.asarray(jattn.kv_head_map(jcfg)).tolist()
            assert hmap[:n_heads] == [i // (n_heads // n_kv)
                                      for i in range(n_heads)]
            assert tuple(tp["blocks"]["attn"]["wq"].shape)[2] \
                == len(hmap) == padded_heads
        t = _toks(tcfg, s=12)
        got, _ = TM.forward(tp, {"tokens": _t(t)}, tcfg)
        want, _ = JM.forward(jp, {"tokens": jnp.asarray(t)}, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _, caches = TM.prefill(tp, {"tokens": _t(t[:, :-1])}, tcfg,
                               max_len=16)
        step, _ = TM.decode_step(tp, caches, _t(t[:, -1]), tcfg)
        np.testing.assert_allclose(step.numpy(), np.asarray(want)[:, -1],
                                   **TOL)


# ------------------------------------------------------------- the engines
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def qwen_padded():
    """qwen3's smoke config (4 heads on 2 kv heads) padded to 6 heads."""
    jcfg = jconfigs.get_smoke(ARCH, padded_heads=6)
    tcfg = tconfigs.get_smoke(ARCH, padded_heads=6)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _traffic(cfg):
    """Prompts of 20, 37 (past the 16-token chunk), 20 (grouped with the
    first), 9, and 37 sharing the second's first 24 tokens."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (20, 37, 20, 9, 37)]
    prompts[4][:24] = prompts[1][:24]
    return list(zip(prompts, (6, 5, 7, 4, 6)))


def _serve(eng, reqs):
    uids = [eng.submit(p, b).uid for p, b in reqs]
    got = eng.run(max_steps=1000)
    return [got[u] for u in uids], eng


@pytest.mark.parametrize("paged", [True, False])
def test_engines_match_jax(qwen_padded, paged):
    jcfg, tcfg, jp, tp = qwen_padded
    kw = dict(max_len=64, capacity=3)
    if paged:
        kw.update(paged=True, page_size=8, prefill_chunk=16)
    reqs = _traffic(tcfg)
    got, eng = _serve(tengine.ContinuousEngine(
        tp, tcfg, tengine.ServeConfig(**kw)), reqs)
    want, jeng = _serve(jengine.ContinuousEngine(
        jp, jcfg, jengine.ServeConfig(**kw)), reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    for k in ("decode_steps", "prefill_compiles") + (
            ("prefix_hits", "chunk_steps") if paged else ()):
        assert eng.stats[k] == jeng.stats[k], k
    if paged:
        assert eng.stats["prefix_hits"] >= 1 and eng.stats["chunk_steps"] >= 1


def test_padded_engine_equals_sliced_engine(qwen_padded):
    """The padded model's paged engine serves the sliced model's tokens."""
    _, tcfg, _, tp = qwen_padded
    reqs = _traffic(tcfg)
    scfg = tengine.ServeConfig(max_len=64, capacity=3, paged=True,
                               page_size=8, prefill_chunk=16)
    got, _ = _serve(tengine.ContinuousEngine(tp, tcfg, scfg), reqs)
    unpadded = dataclasses.replace(tcfg, padded_heads=0)
    want, _ = _serve(tengine.ContinuousEngine(
        _sliced(tp, tcfg.n_heads), unpadded, scfg), reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
