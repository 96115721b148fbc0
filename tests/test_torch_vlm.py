"""The port's VLM (llava-next-34b: a dense backbone whose prompt is
precomputed embeddings; the vision frontend is a stub, as in the reference)
against the JAX package's, with the same weights (moved by
``params_from_numpy``): forward and prefill from embeddings, the paged
and contiguous serving engines with embedding requests (a prompt longer
than the prefill chunk included) against ``repro``'s engines on the same
traffic, the static engine's left-padded embeddings, the prefix cache
never shared by an embedding prompt, and the prompt-length check.

Float32 smoke config; tolerance rtol = atol = 2e-4, as
tests/test_torch_model.py; tokens must match exactly."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "llava-next-34b"
MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    assert tcfg.family == "vlm" and tcfg.input_mode == "embeddings"
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _embeds(rng, d, *shape):
    return rng.standard_normal((*shape, d)).astype(np.float32)


class TestModel:
    def test_forward_from_embeddings(self, setup):
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(0)
        toks = rng.integers(0, tcfg.vocab, (2, 13)).astype(np.int32)
        emb = _embeds(rng, tcfg.d_model, 2, 13)
        for inputs in ({"tokens": toks, "embeds": emb}, {"tokens": toks}):
            want, _ = JM.forward(jp, {k: jnp.asarray(v)
                                      for k, v in inputs.items()}, jcfg)
            got, aux = TM.forward(tp, {k: _t(v) for k, v in inputs.items()},
                                  tcfg)
            _close(got, want)
            assert float(aux["load_balance"]) == float(aux["router_z"]) == 0
        # the embeddings, not the token ids, feed the first layer
        a, _ = TM.forward(tp, {"tokens": _t(toks), "embeds": _t(emb)}, tcfg)
        b, _ = TM.forward(tp, {"tokens": _t(toks[::-1]), "embeds": _t(emb)},
                          tcfg)
        assert torch.equal(a, b)

    def test_prefill_from_embeddings_then_decode(self, setup):
        """Prefill advances the cache by the embeddings' length; decode
        embeds the sampled tokens through ``embed``."""
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(1)
        toks = rng.integers(0, tcfg.vocab, (2, 11)).astype(np.int32)
        emb = _embeds(rng, tcfg.d_model, 2, 11)
        wl, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "embeds": jnp.asarray(emb)}, jcfg, max_len=24)
        gl, gc = TM.prefill(tp, {"tokens": _t(toks), "embeds": _t(emb)},
                            tcfg, max_len=24)
        _close(gl, wl)
        np.testing.assert_array_equal(gc["len"].numpy(), [11] * tcfg.n_layers)
        for _ in range(4):
            tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)
            wl, wc = JM.decode_step(jp, wc, jnp.asarray(tok), jcfg)
            gl, gc = TM.decode_step(tp, gc, _t(tok), tcfg)
            _close(gl, wl)
        for name in ("k", "v"):
            _close(gc[name], wc[name])


# ------------------------------------------------------------- the engines
def _traffic(cfg):
    """Prompts of 20, 37 (past the 16-token chunk), 20 (one prefill group
    with the first) 9 and 12 tokens, each with its own embeddings; the
    last repeats the first's token ids with other embeddings."""
    rng = np.random.default_rng(0)
    reqs = []
    for n, b in ((20, 6), (37, 5), (20, 7), (9, 4), (12, 6)):
        reqs.append((rng.integers(1, cfg.vocab, n).astype(np.int32), b,
                     {"embeds": _embeds(rng, cfg.d_model, n)}))
    reqs.append((reqs[0][0].copy(), 5,
                 {"embeds": _embeds(rng, cfg.d_model, 20)}))
    return reqs


def _serve(eng, reqs, order="fifo"):
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(p, b, extra=e).uid: i
                  for i, (p, b, e) in ((i, reqs[i]) for i in idxs)}
    got = eng.run(max_steps=1000)
    return {i: got[uid] for uid, i in uid_to_idx.items()}, eng


def _paged(**kw):
    base = dict(max_len=MAX_LEN, capacity=3, paged=True, page_size=8,
                prefill_chunk=16)
    base.update(kw)
    return base


class TestEngines:
    @pytest.mark.parametrize("order", ["fifo", "reversed"])
    def test_paged_matches_jax(self, setup, order):
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        got, eng = _serve(tengine.ContinuousEngine(
            tp, tcfg, tengine.ServeConfig(**_paged())), reqs, order)
        want, jeng = _serve(jengine.ContinuousEngine(
            jp, jcfg, jengine.ServeConfig(**_paged())), reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
        for k in ("prefix_hits", "chunk_steps", "decode_steps",
                  "prefill_compiles"):
            assert eng.stats[k] == jeng.stats[k], k
        assert eng.stats["chunk_steps"] >= 3 and eng.stats["prefix_hits"] == 0
        assert eng.pages.used_pages == len(eng.prefix) == 0

    def test_paged_matches_single_request_generate(self, setup):
        """Whole-prompt, grouped and chunked prefills from embeddings give
        B=1 Engine.generate's tokens."""
        _, tcfg, _, tp = setup
        reqs = _traffic(tcfg)
        ref = tengine.Engine(tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN))
        want = [ref.generate(p[None], b, extra_inputs={
            "embeds": e["embeds"][None]})[0] for p, b, e in reqs]
        got, _ = _serve(tengine.ContinuousEngine(
            tp, tcfg, tengine.ServeConfig(**_paged())), reqs)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i])

    def test_contiguous_matches_jax(self, setup):
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        scfg = dict(max_len=MAX_LEN, capacity=3)
        got, _ = _serve(tengine.ContinuousEngine(
            tp, tcfg, tengine.ServeConfig(**scfg)), reqs)
        want, _ = _serve(jengine.ContinuousEngine(
            jp, jcfg, jengine.ServeConfig(**scfg)), reqs)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i])

    def test_embedding_prompts_never_share_prefix_pages(self, setup):
        """Two requests with the same 20 token ids: with embeddings neither
        looks up nor registers pages, and the second's tokens follow its
        own embeddings; without embeddings the second hits the first's
        two full pages (the control)."""
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        first, second = reqs[0], reqs[-1]
        assert np.array_equal(first[0], second[0])
        for eng_mod, params, cfg in ((tengine, tp, tcfg),
                                     (jengine, jp, jcfg)):
            eng = eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                **_paged(capacity=1)))
            got, _ = _serve(eng, [first, second])
            assert eng.stats["prefix_hits"] == 0 and len(eng.prefix) == 0
            assert not np.array_equal(got[0], got[1])
            eng = eng_mod.ContinuousEngine(params, cfg, eng_mod.ServeConfig(
                **_paged(capacity=1)))
            _serve(eng, [(first[0], first[1], None),
                         (second[0], second[1], None)])
            assert eng.stats["prefix_hits"] == 1

    def test_embeds_length_must_match_the_prompt(self, setup):
        jcfg, tcfg, jp, tp = setup
        prompt = np.arange(1, 9, dtype=np.int32)
        emb = np.zeros((7, tcfg.d_model), np.float32)
        for eng_mod, params, cfg in ((tengine, tp, tcfg),
                                     (jengine, jp, jcfg)):
            for paged in (False, True):
                eng = eng_mod.ContinuousEngine(
                    params, cfg, eng_mod.ServeConfig(max_len=MAX_LEN,
                                                     paged=paged))
                with pytest.raises(ValueError, match="'embeds' length 7 must "
                                   "match the prompt length 8"):
                    eng.submit(prompt, 2, extra={"embeds": emb})
                assert eng.stats["submitted"] == 0

    def test_static_engine_left_padded_embeddings(self, setup):
        """The static baseline's batches: embeddings left-padded to the
        batch's longest prompt, as the reference's launcher stacks them."""
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)[:3]
        prompts, budgets = [p for p, _, _ in reqs], [b for _, b, _ in reqs]
        (padded, new, idxs), = tengine.static_batches(prompts, budgets, 3)
        ei = {"embeds": tserve._stack_extra(
            "embeds", [reqs[j][2]["embeds"] for j in idxs], padded.shape[1])}
        np.testing.assert_array_equal(ei["embeds"], jserve._stack_extra(
            "embeds", [reqs[j][2]["embeds"] for j in idxs], padded.shape[1]))
        got = tengine.Engine(tp, tcfg, tengine.ServeConfig(
            max_len=MAX_LEN)).generate(padded, new, extra_inputs=ei)
        want = jengine.Engine(jp, jcfg, jengine.ServeConfig(
            max_len=MAX_LEN)).generate(padded, new, extra_inputs={
                "embeds": jnp.asarray(ei["embeds"])})
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [["--paged", "--prefill-chunk", "16"],
                                  ["--static"]])
def test_serve_launcher_draws_embedding_prompts(mode, capsys):
    """``launch.serve`` gives each VLM request a standard-normal
    (prompt_len, d_model) embedding from the traffic rng."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "5", "--capacity", "3", "--prompt-len-min",
                 "8", "--prompt-len-max", "40", "--new-tokens", "3", *mode])
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve:")]
    report = json.loads(line.split(" ", 1)[1])
    assert report["tokens"] == 15
    if "--paged" in mode:
        assert report["engine"]["prefix_hits"] == 0
        assert report["engine"]["chunk_steps"] >= 1
