"""The port's MoE against the JAX package's, with the same weights (moved by
``params_from_numpy``): routing, the capacity dispatch and the whole layer
(global with dropped copies, dropless, ``moe_groups`` = 2; top-1, top-2 and
top-4), the aux losses, forward, prefill and decode of the dbrx-132b and
llama4-scout smoke configs, and the paged serving engine against
``repro``'s on the same traffic at the config's capacity factor 1.25.

Float32; tolerance rtol = atol = 2e-4, as tests/test_torch_model.py;
expert choices, dropped copies and tokens must match exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
#: (arch, overrides): top-2 of 4 (dbrx smoke), top-4 of 8, top-1 of 4
#: (llama4-scout smoke), and dbrx smoke routed within 2 batch groups
CASES = {"dbrx_top2": ("dbrx-132b", {}),
         "dbrx_top4_of_8": ("dbrx-132b", dict(n_experts=8, top_k=4)),
         "scout_top1": ("llama4-scout-17b-16e", {}),
         "dbrx_groups2": ("dbrx-132b", dict(moe_groups=2))}
ARCHS = ("dbrx-132b", "llama4-scout-17b-16e")


def _configs(arch, **over):
    return (jconfigs.get_smoke(arch, **over), tconfigs.get_smoke(arch, **over))


def _t(x) -> "torch.Tensor":
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _aux_close(got, want):
    assert set(got) == set(want) == {"load_balance", "router_z"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)


def _dropped(expert_idx: np.ndarray, e: int, cap: int) -> int:
    """Copies past capacity in one dispatch scope."""
    counts = np.bincount(np.asarray(expert_idx).reshape(-1), minlength=e)
    return int(np.maximum(counts - cap, 0).sum())


def _cap(t: int, cfg) -> int:
    return min(max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
                   1), t)


@pytest.fixture(scope="module", params=list(CASES))
def layer(request):
    """One MoE layer's weights in both packages and a (4, 24, d) input."""
    jcfg, tcfg = _configs(CASES[request.param][0], **CASES[request.param][1])
    jp = jnn.unwrap(JMoE.init_moe(jax.random.PRNGKey(3), jcfg))
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal(
        (4, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


class TestLayer:
    def test_shapes_are_the_reference_tree(self, layer):
        jcfg, tcfg, jp, _, _ = layer
        assert TMoE.moe_shapes(tcfg) == {k: tuple(v.shape)
                                         for k, v in jp.items()}

    def test_route(self, layer):
        jcfg, tcfg, jp, tp, x = layer
        xt = x.reshape(-1, jcfg.d_model)
        wg, wi, waux = JMoE._route(jp, jnp.asarray(xt), jcfg)
        gg, gi, gaux = TMoE._route(tp, _t(xt), tcfg)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close(gg, wg)
        _aux_close(gaux, waux)

    @pytest.mark.parametrize("cap", ["config", "half", "dropless", "one"])
    def test_dispatch_ffn(self, layer, cap):
        """The reference's routes through both dispatches; capacity the
        config's, half of it (copies drop), every token's (none drop) or
        1."""
        jcfg, tcfg, jp, tp, x = layer
        xt = x.reshape(-1, jcfg.d_model)
        t = xt.shape[0]
        c = {"config": _cap(t, jcfg), "half": _cap(t, jcfg) // 2,
             "dropless": t, "one": 1}[cap]
        gv, ei, _ = JMoE._route(jp, jnp.asarray(xt), jcfg)
        if cap in ("half", "one"):
            assert _dropped(ei, jcfg.n_experts, c) > 0
        want = JMoE._dispatch_ffn(jp, jnp.asarray(xt), gv, ei, jcfg, c)
        got = TMoE._dispatch_ffn(tp, _t(xt), _t(gv), _t(ei).long(), tcfg, c)
        _close(got, want)

    @pytest.mark.parametrize("cf,dropless", [(1.25, False), (0.5, False),
                                              (1.25, True)])
    def test_moe(self, layer, cf, dropless):
        """The config's capacity factor, a tight one under which copies
        drop (asserted, per dispatch scope), and dropless."""
        jcfg, tcfg, jp, tp, x = layer
        jcfg, tcfg = (dataclasses.replace(c, capacity_factor=cf)
                      for c in (jcfg, tcfg))
        if cf < 1:
            g = jcfg.moe_groups or 1
            for xt in x.reshape(g, -1, jcfg.d_model):
                _, ei, _ = JMoE._route(jp, jnp.asarray(xt), jcfg)
                assert _dropped(ei, jcfg.n_experts,
                                _cap(xt.shape[0], jcfg)) > 0
        want, waux = JMoE.moe(jp, jnp.asarray(x), jcfg, dropless=dropless)
        got, gaux = TMoE.moe(tp, _t(x), tcfg, dropless=dropless)
        _close(got, want)
        _aux_close(gaux, waux)

    def test_groups_route_within_each_group(self):
        """moe_groups = 2 routes and drops within each half of the batch:
        not the global result, and the mean of the halves' aux losses."""
        jcfg, tcfg = _configs("dbrx-132b", moe_groups=2, capacity_factor=0.5)
        jp = jnn.unwrap(JMoE.init_moe(jax.random.PRNGKey(3), jcfg))
        tp = {k: _t(v) for k, v in jp.items()}
        x = np.random.default_rng(0).standard_normal(
            (4, 24, jcfg.d_model)).astype(np.float32)
        halves = x.reshape(2, -1, jcfg.d_model)
        tg = halves.shape[1]
        for h in halves:
            _, ei, _ = JMoE._route(jp, jnp.asarray(h), jcfg)
            assert _dropped(ei, jcfg.n_experts, _cap(tg, jcfg)) > 0
        got, gaux = TMoE.moe(tp, _t(x), tcfg)
        glob, _ = TMoE.moe(tp, _t(x), dataclasses.replace(tcfg,
                                                          moe_groups=0))
        assert not torch.allclose(got, glob, **TOL)
        want = [TMoE.moe(tp, _t(h)[None], dataclasses.replace(
            tcfg, moe_groups=0)) for h in halves]
        _close(got.reshape(2, tg, -1), np.stack([w[0][0].numpy()
                                                 for w in want]))
        for k in gaux:
            np.testing.assert_allclose(
                float(gaux[k]), np.mean([float(w[1][k]) for w in want]),
                **TOL)

    def test_groups_unused_when_tokens_do_not_divide(self):
        """t % moe_groups != 0 falls back to the global dispatch."""
        _, tcfg = _configs("dbrx-132b", moe_groups=5)
        jcfg = jconfigs.get_smoke("dbrx-132b", moe_groups=5)
        jp = jnn.unwrap(JMoE.init_moe(jax.random.PRNGKey(3), jcfg))
        x = np.random.default_rng(1).standard_normal(
            (2, 11, jcfg.d_model)).astype(np.float32)
        want, waux = JMoE.moe(jp, jnp.asarray(x), jcfg)
        got, gaux = TMoE.moe({k: _t(v) for k, v in jp.items()}, _t(x), tcfg)
        _close(got, want)
        _aux_close(gaux, waux)

    def test_copies_summed_in_ascending_expert_order(self):
        """Each token's k contributions are added left to right in
        ascending expert id, whatever the top-k order: a bf16 sum of the
        same copies in that order, bit for bit."""
        _, tcfg = _configs("dbrx-132b", n_experts=8, top_k=4)
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
        gen = torch.Generator().manual_seed(0)
        tp = {k: (torch.randn(s, generator=gen) * 0.1).to(torch.bfloat16)
              for k, s in TMoE.moe_shapes(tcfg).items()}
        xt = torch.randn((40, tcfg.d_model), generator=gen).to(torch.bfloat16)
        gv, ei, _ = TMoE._route(tp, xt, tcfg)
        got = TMoE._dispatch_ffn(tp, xt, gv, ei, tcfg, 40)
        out = TMoE._expert_ffn(tp, xt[None].expand(tcfg.n_experts, -1, -1)
                               .contiguous(), tcfg)            # (e, t, d)
        order = torch.sort(ei, dim=-1)
        want = None
        for j in range(tcfg.top_k):
            e_j = order.values[:, j]
            g_j = gv.gather(1, order.indices[:, j:j + 1]).to(torch.bfloat16)
            c = out[e_j, torch.arange(40)] * g_j
            want = c if want is None else want + c
        assert torch.equal(got, want)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


class TestModel:
    @pytest.mark.parametrize("s", [16, 13])
    def test_forward_logits_and_aux(self, model, s):
        jcfg, tcfg, jp, tp = model
        toks = np.random.default_rng(s).integers(0, tcfg.vocab,
                                                 (2, s)).astype(np.int32)
        want, waux = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        got, gaux = TM.forward(tp, {"tokens": _t(toks)}, tcfg)
        _close(got, want)
        _aux_close(gaux, waux)
        assert float(gaux["load_balance"]) > 0

    def test_prefill_then_decode(self, model):
        """Prefill (capacity-bound) then 5 dropless decode steps: logits,
        caches and greedy tokens."""
        jcfg, tcfg, jp, tp = model
        toks = np.random.default_rng(2).integers(0, tcfg.vocab,
                                                 (2, 14)).astype(np.int32)
        wl, wc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            max_len=32)
        gl, gc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg, max_len=32)
        _close(gl, wl)
        for _ in range(5):
            tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)
            np.testing.assert_array_equal(torch.argmax(gl, -1).numpy(), tok)
            wl, wc = JM.decode_step(jp, wc, jnp.asarray(tok), jcfg)
            gl, gc = TM.decode_step(tp, gc, _t(tok), tcfg)
            _close(gl, wl)
        for name in ("k", "v"):
            _close(gc[name], wc[name])
        np.testing.assert_array_equal(gc["len"].numpy(), np.asarray(wc["len"]))


class TestConvert:
    def test_router_stays_float32(self):
        jcfg, tcfg = _configs("dbrx-132b", dtype="bfloat16")
        jp = jax.tree.map(np.asarray,
                          jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg)))
        tp = params_from_numpy(jp, tcfg, device="cpu")
        ffn = tp["blocks"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        np.testing.assert_array_equal(ffn["router"].numpy(),
                                      jp["blocks"]["ffn"]["router"])
        for name in ("w_gate", "w_up", "w_down"):
            assert ffn[name].dtype == torch.bfloat16
            assert tuple(ffn[name].shape) == jp["blocks"]["ffn"][name].shape
        del jp["blocks"]["ffn"]["router"]
        with pytest.raises(KeyError, match="blocks/ffn/router"):
            params_from_numpy(jp, tcfg, device="cpu")

    def test_init_keeps_the_router_float32(self):
        tcfg = tconfigs.get_smoke("dbrx-132b", dtype="bfloat16")
        tp = TM.init_lm(tcfg, seed=0, device="cpu")
        assert tp["blocks"]["ffn"]["router"].dtype == torch.float32
        assert tp["blocks"]["ffn"]["w_down"].dtype == torch.bfloat16


# ------------------------------------------------------------- the engines
MAX_LEN = 64


def _traffic(vocab):
    """Two 20-token prompts (one prefill group: they drop over each other's
    copies), one past the 16-token chunk, one sharing a 2-page prefix with
    the first, and two short ones."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, vocab, n).astype(np.int32), b)
            for n, b in ((20, 6), (37, 5), (20, 7), (9, 4), (12, 6))]
    reqs.append((np.concatenate([reqs[0][0][:17], [5, 7, 9]])
                 .astype(np.int32), 5))
    return reqs


def _serve(eng, reqs, order="fifo"):
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(*reqs[i]).uid: i for i in idxs}
    got = eng.run(max_steps=1000)
    return {i: got[uid] for uid, i in uid_to_idx.items()}, eng


def _paged(**kw):
    return dict(max_len=MAX_LEN, capacity=3, paged=True, page_size=8,
                prefill_chunk=16, **kw)


class TestEngines:
    @pytest.mark.parametrize("order", ["fifo", "reversed"])
    def test_paged_matches_jax_at_capacity_factor_1_25(self, model, order):
        """The config's own capacity factor: grouped prefills drop copies,
        chunks do not; the port's engine groups and chunks as the
        reference's, token for token."""
        jcfg, tcfg, jp, tp = model
        assert tcfg.capacity_factor == 1.25
        reqs = _traffic(tcfg.vocab)
        got, eng = _serve(tengine.ContinuousEngine(
            tp, tcfg, tengine.ServeConfig(**_paged())), reqs, order)
        want, jeng = _serve(jengine.ContinuousEngine(
            jp, jcfg, jengine.ServeConfig(**_paged())), reqs, order)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"request {i} ({order})")
        for k in ("prefix_hits", "chunk_steps", "decode_steps", "admitted"):
            assert eng.stats[k] == jeng.stats[k], k
        assert eng.stats["prefix_hits"] >= 1 and eng.stats["chunk_steps"] >= 2

    def test_capacity_bound_engine_differs_from_generate_as_the_reference(
            self, model):
        """At 1.25 a request's tokens depend on its prefill group (the
        capacity is shared) and on whether it was chunked (dropless): the
        engine is not B=1 Engine.generate, in the reference as in the
        port, and for the same requests (ROADMAP.md, Queue 3, reference
        caveats)."""
        jcfg, tcfg, jp, tp = model
        reqs = _traffic(tcfg.vocab)
        differs = []
        for eng_mod, params, cfg in ((tengine, tp, tcfg),
                                     (jengine, jp, jcfg)):
            ref = eng_mod.Engine(params, cfg, eng_mod.ServeConfig(
                max_len=MAX_LEN))
            got, _ = _serve(eng_mod.ContinuousEngine(
                params, cfg, eng_mod.ServeConfig(**_paged())), reqs)
            differs.append([not np.array_equal(got[i], ref.generate(
                p[None], b)[0]) for i, (p, b) in enumerate(reqs)])
        assert any(differs[0]) and differs[0] == differs[1]

    def test_dropless_engine_matches_single_request_generate(self, model):
        """At capacity_factor = n_experts / top_k no dispatch drops, and
        the paged engine equals B=1 Engine.generate, as a dense model's."""
        jcfg, tcfg, _, tp = model
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
        reqs = _traffic(tcfg.vocab)
        ref = tengine.Engine(tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN))
        want = [ref.generate(p[None], b)[0] for p, b in reqs]
        for order in ("fifo", "reversed"):
            got, _ = _serve(tengine.ContinuousEngine(
                tp, tcfg, tengine.ServeConfig(**_paged())), reqs, order)
            for i in range(len(reqs)):
                np.testing.assert_array_equal(got[i], want[i])

    def test_contiguous_matches_jax(self, model):
        jcfg, tcfg, jp, tp = model
        reqs = _traffic(tcfg.vocab)
        scfg = dict(max_len=MAX_LEN, capacity=3)
        got, _ = _serve(tengine.ContinuousEngine(
            tp, tcfg, tengine.ServeConfig(**scfg)), reqs)
        want, _ = _serve(jengine.ContinuousEngine(
            jp, jcfg, jengine.ServeConfig(**scfg)), reqs)
        for i in range(len(reqs)):
            np.testing.assert_array_equal(got[i], want[i])

    def test_generate_matches_jax(self, model):
        jcfg, tcfg, jp, tp = model
        prompts = np.random.default_rng(4).integers(
            1, tcfg.vocab, (3, 11)).astype(np.int32)
        want = jengine.Engine(jp, jcfg, jengine.ServeConfig(
            max_len=MAX_LEN)).generate(prompts, 6)
        got = tengine.Engine(tp, tcfg, tengine.ServeConfig(
            max_len=MAX_LEN)).generate(prompts, 6)
        np.testing.assert_array_equal(got, want)
