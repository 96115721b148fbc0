"""The port's encoder-decoder (seamless-m4t-large-v2: a bidirectional
encoder over precomputed frame embeddings, the speech frontend a stub as
in the reference, and a decoder with self- and cross-attention) against
the JAX package's, with the same weights (moved by ``params_from_numpy``):
the init tree and scales, forward, prefill then decode, ``Engine.generate``
with ``enc_embeds``, and the contiguous continuous engine against
``repro``'s on requests that each carry their own encoder context (a
same-length pair prefilled as one group).  A context of the wrong shape
and paged serving are refused with the reference's messages, and the
launcher serves the family.

Float32 smoke config; JAX's model runs with ``use_pallas=True`` (its
flash kernel in interpret mode on the CPU, bidirectional in the encoder).
Tolerance rtol = atol = 2e-4, as tests/test_torch_model.py; tokens must
match exactly."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "seamless-m4t-large-v2"
MAX_LEN = 32


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    assert tcfg.family == "enc_dec" and tcfg.enc_layers == tcfg.dec_layers == 2
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _ctx(rng, cfg, *lead):
    return rng.standard_normal((*lead, cfg.enc_len, cfg.d_model)).astype(
        np.float32)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


class TestParams:
    def test_converted_tree_is_the_reference_tree(self, setup):
        _, tcfg, jp, tp = setup
        want = dict(_flat(jax.tree.map(np.asarray, jp)))
        got = dict(_flat(tp))
        assert set(got) == set(want)
        assert {"enc_ln", "dec_embed", "dec_ln", "lm_head",
                "dec_blocks/ln_x", "dec_blocks/xattn/wq"} <= set(got)
        assert not {"embed", "ln_f"} & set(got)
        for name, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(), want[name], name)

    def test_missing_cross_leaves_raise(self, setup):
        _, tcfg, jp, _ = setup
        tree = jax.tree.map(np.asarray, jp)
        for leaf in ("xattn", "ln_x"):
            cut = dict(tree, dec_blocks={k: v for k, v in
                                         tree["dec_blocks"].items()
                                         if k != leaf})
            with pytest.raises(KeyError, match=f"dec_blocks/{leaf}"):
                params_from_numpy(cut, tcfg, device="cpu")

    def test_init_tree_and_scales(self):
        """The reference's tree leaf for leaf, its init scales: dec_embed
        unit normal, lm_head and the attention and MLP inputs d**-0.5, wo
        (n_heads*hd)**-0.5, w_down d_ff**-0.5; norm gains ones and float32
        in a bf16 model."""
        cfg = tconfigs.get_smoke(ARCH, dtype="bfloat16", d_model=256,
                                 d_ff=512)
        tp = TM.init_lm(cfg, seed=0, device="cpu")
        want = JM.init_lm_shapes(jax.random.PRNGKey(0), jconfigs.get_smoke(
            ARCH, d_model=256, d_ff=512))
        want = {"/".join(str(k.key) for k in path): tuple(leaf.value.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=jnn.is_param)[0]}
        got = dict(_flat(tp))
        assert {k: tuple(v.shape) for k, v in got.items()} == want
        d, hd = cfg.d_model, cfg.hd
        scales = {"dec_embed": 1.0, "lm_head": d ** -0.5, "wq": d ** -0.5,
                  "wk": d ** -0.5, "wv": d ** -0.5,
                  "wo": (cfg.n_heads * hd) ** -0.5, "w_up": d ** -0.5,
                  "w_down": cfg.d_ff ** -0.5}
        for path, leaf in got.items():
            name = path.split("/")[-1]
            if name in TM.NORM_LEAVES:
                assert leaf.dtype == torch.float32, path
                assert torch.equal(leaf, torch.ones_like(leaf)), path
                continue
            assert leaf.dtype == torch.bfloat16, path
            std = leaf.float().std().item()
            assert abs(std / scales[name] - 1) < 0.1, (path, std)


class TestModel:
    @pytest.fixture(scope="class")
    def pallas(self, setup):
        jcfg, tcfg, jp, tp = setup
        return dataclasses.replace(jcfg, use_pallas=True), tcfg, jp, tp

    @pytest.mark.parametrize("s", [9, 16])
    def test_forward_logits(self, pallas, s):
        jcfg, tcfg, jp, tp = pallas
        rng = np.random.default_rng(s)
        toks = rng.integers(0, tcfg.vocab, (2, s)).astype(np.int32)
        enc = _ctx(rng, tcfg, 2)
        want, waux = JM.forward(jp, {"tokens": jnp.asarray(toks),
                                     "enc_embeds": jnp.asarray(enc)}, jcfg)
        got, aux = TM.forward(tp, {"tokens": _t(toks),
                                   "enc_embeds": _t(enc)}, tcfg)
        _close(got, want)
        for k in ("load_balance", "router_z"):
            assert float(aux[k]) == float(waux[k]) == 0.0
        # the context, not only the tokens, reaches the logits
        other, _ = TM.forward(tp, {"tokens": _t(toks),
                                   "enc_embeds": _t(enc[::-1])}, tcfg)
        assert not torch.allclose(other[0], got[0])

    def test_prefill_then_decode(self, pallas):
        jcfg, tcfg, jp, tp = pallas
        rng = np.random.default_rng(1)
        toks = rng.integers(0, tcfg.vocab, (2, 11)).astype(np.int32)
        enc = _ctx(rng, tcfg, 2)
        wl, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "enc_embeds": jnp.asarray(enc)}, jcfg,
                            max_len=24)
        gl, gc = TM.prefill(tp, {"tokens": _t(toks), "enc_embeds": _t(enc)},
                            tcfg, max_len=24)
        _close(gl, wl)
        shape = (tcfg.dec_layers, 2, tcfg.enc_len, tcfg.n_kv_heads, tcfg.hd)
        for i, name in enumerate(("k", "v")):
            assert tuple(gc["cross"][name].shape) == shape
            _close(gc["cross"][name], wc["cross"][i])
        np.testing.assert_array_equal(gc["self"]["len"].numpy(),
                                      [11] * tcfg.dec_layers)
        for _ in range(4):
            tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)
            wl, wc = JM.decode_step(jp, wc, jnp.asarray(tok), jcfg)
            gl, gc = TM.decode_step(tp, gc, _t(tok), tcfg)
            _close(gl, wl)
        for name in ("k", "v"):
            _close(gc["self"][name], wc["self"][name])
        np.testing.assert_array_equal(gc["self"]["len"].numpy(),
                                      np.asarray(wc["self"]["len"]))

    def test_decode_rejects_a_page_table(self, setup):
        _, tcfg, _, tp = setup
        caches = TM.alloc_slot_caches(tcfg, 2, MAX_LEN, device="cpu")
        with pytest.raises(ValueError, match="paged decode supports"):
            TM.decode_step(tp, caches, torch.zeros(2, dtype=torch.int32),
                           tcfg, pt=torch.zeros((2, 2), dtype=torch.int32))


# ------------------------------------------------------------- the engines
def _traffic(cfg):
    """Prompts of 5, 11, 5 (one prefill group with the first), 8 and 14
    tokens, each with its own encoder context, 3-7 new tokens."""
    rng = np.random.default_rng(0)
    return [(rng.integers(1, cfg.vocab, n).astype(np.int32), b,
             {"enc_embeds": _ctx(rng, cfg)})
            for n, b in ((5, 6), (11, 5), (5, 7), (8, 3), (14, 6))]


def _serve(eng, reqs, order="fifo"):
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(p, b, extra=e).uid: i
                  for i, (p, b, e) in ((i, reqs[i]) for i in idxs)}
    got = eng.run(max_steps=1000)
    return {i: got[uid] for uid, i in uid_to_idx.items()}, eng


def _engine(mod, params, cfg, reqs, **kw):
    return mod.ContinuousEngine(
        params, cfg, mod.ServeConfig(max_len=MAX_LEN, capacity=3, **kw),
        example_extra=reqs[0][2])


class TestEngines:
    def test_generate_matches_jax(self, setup):
        jcfg, tcfg, jp, tp = setup
        rng = np.random.default_rng(2)
        prompts = rng.integers(1, tcfg.vocab, (2, 7)).astype(np.int32)
        enc = _ctx(rng, tcfg, 2)
        got = tengine.Engine(tp, tcfg, tengine.ServeConfig(
            max_len=MAX_LEN)).generate(prompts, 6,
                                       extra_inputs={"enc_embeds": enc})
        want = jengine.Engine(jp, jcfg, jengine.ServeConfig(
            max_len=MAX_LEN)).generate(prompts, 6, extra_inputs={
                "enc_embeds": jnp.asarray(enc)})
        assert got.shape == (2, 6)
        np.testing.assert_array_equal(got, np.asarray(want))

    @pytest.mark.parametrize("order", ["fifo", "reversed"])
    def test_contiguous_matches_jax(self, setup, order):
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        got, eng = _serve(_engine(tengine, tp, tcfg, reqs), reqs, order)
        want, jeng = _serve(_engine(jengine, jp, jcfg, reqs), reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
        for k in ("decode_steps", "prefill_compiles", "admitted"):
            assert eng.stats[k] == jeng.stats[k], k
        # the two 5-token prompts prefilled as one group
        assert eng.stats["prefill_compiles"] == 4
        assert tuple(eng.caches["cross"]["k"].shape) == (
            tcfg.dec_layers, 3, tcfg.enc_len, tcfg.n_kv_heads, tcfg.hd)

    def test_contiguous_matches_single_request_generate(self, setup):
        """Grouped and single prefills give each request B=1
        Engine.generate's tokens from its own context: no slot reads
        another's cross K/V."""
        _, tcfg, _, tp = setup
        reqs = _traffic(tcfg)
        ref = tengine.Engine(tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN))
        want = [ref.generate(p[None], b, extra_inputs={
            "enc_embeds": e["enc_embeds"][None]})[0] for p, b, e in reqs]
        got, _ = _serve(_engine(tengine, tp, tcfg, reqs), reqs)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i])
        # the context matters: the first prompt with the second's context
        other = ref.generate(reqs[0][0][None], reqs[0][1], extra_inputs={
            "enc_embeds": reqs[1][2]["enc_embeds"][None]})[0]
        assert not np.array_equal(other, want[0])

    def test_context_of_another_shape_raises(self, setup):
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        prompt = np.arange(1, 6, dtype=np.int32)
        short = np.zeros((tcfg.enc_len - 1, tcfg.d_model), np.float32)
        for mod, params, cfg in ((tengine, tp, tcfg), (jengine, jp, jcfg)):
            eng = _engine(mod, params, cfg, reqs)
            for extra in ({"enc_embeds": short}, None):
                with pytest.raises(ValueError) as err:
                    eng.submit(prompt, 2, extra=extra)
                assert str(err.value).startswith(
                    f"extra 'enc_embeds' must have shape "
                    f"({tcfg.enc_len}, {tcfg.d_model}), got ")
            assert eng.stats["submitted"] == 0

    def test_paged_engine_refuses_enc_dec(self, setup):
        jcfg, tcfg, jp, tp = setup
        reqs = _traffic(tcfg)
        msgs = []
        for mod, params, cfg in ((tengine, tp, tcfg), (jengine, jp, jcfg)):
            with pytest.raises(ValueError, match="paged serving supports") \
                    as err:
                _engine(mod, params, cfg, reqs, paged=True)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        assert "not 'enc_dec'" in msgs[0]


@pytest.mark.parametrize("mode", [[], ["--static"]])
def test_serve_launcher_serves_enc_dec(mode, capsys):
    """``launch.serve`` draws one (enc_len, d_model) context that every
    request shares, as the reference's launcher does, and serves."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "4", "--capacity", "3", "--prompt-len-min",
                 "4", "--prompt-len-max", "12", "--new-tokens", "3", *mode])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve:")]
    assert len(lines) == 1
    tag, body = lines[0].split(" ", 1)
    assert tag == ("[serve:static]" if mode else "[serve:continuous]")
    assert json.loads(body)["tokens"] == 12


def test_serve_launcher_refuses_paged():
    with pytest.raises(ValueError, match="not 'enc_dec'"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "2", "--paged"])
