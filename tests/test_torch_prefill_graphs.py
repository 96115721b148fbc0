"""The continuous engine's captured whole-prompt prefills and chunk steps
(``serve/graphs.py``: ``PrefillStep``, ``ChunkStep``, ``PrefillGraphs``)
on the CPU, where each runs its static-buffer step eagerly.

* For every family, paged where it pages and contiguous, an engine whose
  prefill shapes repeat (so that each is dispatched eagerly, then through
  its static buffers, then again) gives the tokens of the same engine with
  ``step_graphs`` off and of the reference's continuous engine, from the
  same weights (moved by ``params_from_numpy``); ``prefill_compiles``
  equals the reference's; every cache leaf keeps its storage.
* ``prefill_chunk`` with ``slot`` and ``n_valid`` as 0-dim tensors equals
  the int version bitwise and the reference's ``prefill_chunk`` within
  the chunk tests' tolerance (tests/test_torch_model.py, 2e-4).
* A shape is captured on its ``CAPTURE_AT``-th sighting and replayed
  after; every captured step is kept, so shapes in rotation are captured
  once each; a schedule swap drops every prefill and chunk step;
  ``step_graphs=False`` keeps eager dispatch.
"""

import dataclasses
import functools

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
from repro_torch.core.cache import PendingPut, ScheduleCache  # noqa: E402
from repro_torch.core.registry import schedule_cache  # noqa: E402
from repro_torch.core.schedule import Schedule  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402

MAX_LEN = 64
PAGED = dict(paged=True, page_size=8, prefill_chunk=8)
#: sightings a shape needs to be captured and then replayed once
SEEN = graphs.CAPTURE_AT + 1
#: prompts of 6 tokens (``SEEN`` groups of two at capacity 2) and four
#: longer ones: past the chunk on a paged engine (two chunks each) and
#: past the 32-token window on danube's
SHORT, LONG = (6,) * (2 * SEEN), (11,) * 4
#: case -> (config, engine settings, prompt lengths)
CASES = {
    "dense_paged": ("qwen3-1.7b", PAGED, SHORT + LONG),
    "dense_contiguous": ("qwen3-1.7b", {}, SHORT + LONG),
    "window_ring": ("h2o-danube-1.8b", {}, SHORT + (40,) * 4),
    "moe_paged": ("dbrx-132b", PAGED, SHORT + LONG),
    "moe_contiguous": ("dbrx-132b", {}, SHORT + LONG),
    "vlm_paged": ("llava-next-34b", PAGED, SHORT + LONG),
    "vlm_contiguous": ("llava-next-34b", {}, SHORT + LONG),
    "ssm": ("mamba2-2.7b", {}, SHORT + LONG),
    "hybrid": ("zamba2-7b", {}, SHORT + LONG),
    "enc_dec": ("seamless-m4t-large-v2", {}, SHORT + LONG),
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _traffic(cfg, lens, seed=0):
    """(prompt, new tokens, extra) a request: 3 new tokens each; a VLM's
    prompts as standard-normal embeddings, an encoder-decoder's each with
    its own context."""
    rng = np.random.default_rng(seed)
    reqs = []
    for n in lens:
        extra = None
        if cfg.family == "enc_dec":
            extra = {"enc_embeds": rng.standard_normal(
                (cfg.enc_len, cfg.d_model)).astype(np.float32)}
        elif cfg.input_mode == "embeddings":
            extra = {"embeds": rng.standard_normal(
                (n, cfg.d_model)).astype(np.float32)}
        reqs.append((rng.integers(1, cfg.vocab, n).astype(np.int32), 3,
                     extra))
    return reqs


def _serve(mod, params, cfg, reqs, **scfg):
    eng = mod.ContinuousEngine(
        params, cfg, mod.ServeConfig(max_len=MAX_LEN, capacity=2, **scfg),
        example_extra=reqs[0][2])
    uids = [eng.submit(p, b, extra=e).uid for p, b, e in reqs]
    out = eng.run(max_steps=1000)
    return eng, [out[u] for u in uids]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference config, port config, reference params, port params) of
    ``arch``'s smoke variant: the same weights."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_prefill_equals_eager_and_the_reference(case):
    arch, scfg, lens = CASES[case]
    jcfg, tcfg, jp, tp = _model(arch)
    reqs = _traffic(tcfg, lens)
    jeng, want = _serve(jengine, jp, jcfg, reqs, **scfg)

    eng = tengine.ContinuousEngine(
        tp, tcfg, tengine.ServeConfig(max_len=MAX_LEN, capacity=2, **scfg),
        example_extra=reqs[0][2])
    storage = [(path, leaf.data_ptr()) for path, leaf in _leaves(eng.caches)]
    uids = [eng.submit(p, b, extra=e).uid for p, b, e in reqs]
    out = eng.run(max_steps=1000)
    got = [out[u] for u in uids]
    eager_eng, eager = _serve(tengine, tp, tcfg, reqs, step_graphs=False,
                              **scfg)

    for i, (g, e, w) in enumerate(zip(got, eager, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(e, w, err_msg=f"request {i} (eager)")
    assert [(path, leaf.data_ptr())
            for path, leaf in _leaves(eng.caches)] == storage
    assert eng.stats["prefill_compiles"] == jeng.stats["prefill_compiles"]
    assert eager_eng.prefill_graphs is None
    pg = eng.prefill_graphs
    # the groups of 6: eager, then captured, then replayed; a paged
    # engine's 8 chunk steps too (a contiguous engine's two long groups
    # stay eager)
    assert pg.sightings[next(iter(pg.sightings))] == SEEN
    chunks = 2 * len(LONG)
    assert (pg.captures, pg.replays) == (
        (2, 1 + chunks - graphs.CAPTURE_AT) if scfg else (1, 1))


# ------------------------------------------- tensor slot and n_valid
@pytest.fixture(scope="module")
def dense():
    """qwen3's smoke model; the reference's on its Pallas path (interpret
    mode), as tests/test_torch_model.py runs it."""
    jcfg, tcfg, jp, tp = _model("qwen3-1.7b")
    return dataclasses.replace(jcfg, use_pallas=True), tcfg, jp, tp


@pytest.mark.parametrize("start,chunk,n_valid", [(0, 8, 8), (16, 16, 11),
                                                 (40, 16, 8)])
def test_prefill_chunk_takes_device_scalars(dense, start, chunk, n_valid):
    """Slot 2 of 3 holds ``start`` tokens in pages 13-18 of a 6-page
    table (48 positions): a full chunk, a padded final one, and padding
    past the table (the trash page)."""
    jcfg, tcfg, jp, tp = dense
    ps, n_pages, cap = 8, 6, 3
    ex = {"tokens": np.zeros((1, 8), np.int32)}
    jc, axes = JM.alloc_paged_caches(jp, jcfg, cap, n_pages * ps, ps,
                                     cap * n_pages + 1, ex)
    jc = JM.set_slot_lens(jc, 2, jnp.int32(start), axes)
    before = {k: np.array(v) for k, v in jc.items()}
    pt = np.zeros((1, n_pages), np.int32)
    pt[0] = [13, 14, 15, 16, 17, 18]
    buf = np.zeros((1, chunk), np.int32)
    buf[0, :n_valid] = np.random.default_rng(5).integers(0, tcfg.vocab,
                                                         n_valid)
    want, jc = JM.prefill_chunk(jp, jc, jnp.asarray(buf), jnp.asarray(pt),
                                jnp.int32(2), jnp.int32(n_valid), jcfg, axes)
    runs = []
    for slot, nv in ((2, n_valid), (torch.tensor(2), torch.tensor(
            n_valid, dtype=torch.int32))):
        tc = {k: torch.from_numpy(v.copy()) for k, v in before.items()}
        got, tc = TM.prefill_chunk(tp, tc, torch.from_numpy(buf),
                                   torch.from_numpy(pt), slot, nv, tcfg)
        runs.append((got, tc))
    (gi, ci), (gt, ct) = runs
    assert torch.equal(gi, gt)
    for k in ci:
        assert torch.equal(ci[k], ct[k]), k
    np.testing.assert_allclose(gt.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(jc["len"]))
    # the pages this chunk wrote (the trash page 0 takes the padding)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name][:, 1:].numpy(),
                                   np.asarray(jc[name])[:, 1:], rtol=2e-4,
                                   atol=2e-4)


# ----------------------------------------------------- capture rules
class FakeStep(graphs.CapturedStep):
    """A step whose run counts itself; its static output is a tensor."""

    def __init__(self, pool):
        super().__init__(torch.device("cpu"), pool)
        self.runs = 0
        self.dropped = False
        self.logits = torch.zeros(1)

    def _step(self):
        self.runs += 1

    def drop(self):
        super().drop()
        self.dropped = True


def _maker(made):
    def make(key):
        def build(pool):
            made[key] = FakeStep(pool)
            return made[key]
        return build
    return make


def test_a_shape_is_captured_on_its_capture_at_sighting():
    pg = graphs.PrefillGraphs(torch.device("cpu"),
                              obs_metrics.MetricsRegistry())
    made = {}
    make = _maker(made)
    for _ in range(graphs.CAPTURE_AT - 1):                   # eager
        assert pg.run("a", make("a"), {}) is None
    assert "a" not in made and pg.captures == 0
    assert pg.run("a", make("a"), {}) is made["a"].logits   # captured
    assert (pg.captures, pg.replays, made["a"].runs) == (1, 0, 1)
    pg.run("a", make("a"), {})                               # replayed
    assert (pg.captures, pg.replays, made["a"].runs) == (1, 1, 2)
    pg.drop()
    assert not pg.steps and made["a"].dropped
    old = made["a"]
    pg.run("a", make("a"), {})       # seen before: captured at once
    assert made["a"] is not old and pg.captures == 2
    assert pg.pool_bytes() is None   # no pool on the CPU


@pytest.mark.parametrize("rotations", [2, 5])
def test_shapes_in_rotation_are_captured_once_each(rotations):
    """Three shapes in turn: each is captured once, at its
    ``CAPTURE_AT``-th sighting, and every later sighting replays it."""
    pg = graphs.PrefillGraphs(torch.device("cpu"),
                              obs_metrics.MetricsRegistry())
    made = {}
    make = _maker(made)
    n = graphs.CAPTURE_AT + rotations - 1
    for _ in range(n):
        for key in "abc":
            pg.run(key, make(key), {})
    assert sorted(pg.steps) == ["a", "b", "c"]
    assert pg.captures == 3 and pg.replays == 3 * (rotations - 1)
    assert all(made[k].runs == rotations and not made[k].dropped
               for k in "abc")


def _commit(store: ScheduleCache) -> None:
    store.commit([PendingPut(
        kernel_name="paged_gather", signature='{"b": 1}',
        schedule=Schedule(knobs={"rows": 1, "n_chunks": 1}), energy=1e-9,
        tests_passed=True)])


def test_schedule_swap_drops_every_prefill_and_chunk_step(dense):
    _, tcfg, _, tp = dense
    # the 6s' group shape and the chunk shape are each sighted
    # ``CAPTURE_AT`` times: each captured at its last sighting
    k = graphs.CAPTURE_AT
    reqs = _traffic(tcfg, (6,) * (2 * k) + (11,) * -(-k // 2))
    store = ScheduleCache()
    with schedule_cache(store):
        eng = tengine.ContinuousEngine(tp, tcfg, tengine.ServeConfig(
            max_len=MAX_LEN, capacity=2, **PAGED))
        for p, b, _ in reqs:
            eng.submit(p, b)
        eng.run(max_steps=1000)
        pg = eng.prefill_graphs
        steps = list(pg.steps.values())
        assert len(steps) == 2 and pg.captures == 2
        _commit(store)
        for p, b, _ in reqs[:2]:
            eng.submit(p, b)
        eng.step()                     # the swap, then the (2, 6) prefill
        assert eng.stats["schedule_swaps"] == 1
        assert all(s.graph is None and s._stale for s in steps)
        assert len(pg.steps) == 1 and pg.steps[next(iter(pg.steps))] \
            not in steps
        assert pg.captures == 3        # a seen shape re-captures at once
        eng.run(max_steps=1000)


def test_step_graphs_off_keeps_eager_prefill(dense):
    _, tcfg, _, tp = dense
    eng = tengine.ContinuousEngine(tp, tcfg, tengine.ServeConfig(
        max_len=MAX_LEN, capacity=2, step_graphs=False, **PAGED))
    assert eng.prefill_graphs is None
    eng._make_dispatchers()
    assert eng.prefill_graphs is None
