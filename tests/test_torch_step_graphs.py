"""The continuous engine's captured decode step (``serve/graphs.py``) on the
CPU, where the step graph runs its static-buffer step eagerly.

* For every family the one-device engine serves (dense paged and
  contiguous, the sliding-window ring, MoE, VLM, SSM, hybrid, enc-dec,
  padded heads) one step through the static buffers leaves every cache
  leaf at its storage, shape and dtype, writes the static logits, and
  equals an eager ``decode_step`` on a copy of the caches bitwise: the
  conditions for capturing the step on a card.
* Engine tokens with ``step_graphs`` on equal those with it off and
  ``repro``'s single-request generation (dense paged, dense contiguous,
  SSM).
* A schedule swap drops the graph and the next decode builds it anew.
* Launch crediting: each replay adds the launches its capture recorded,
  held with fake kernel counters.
"""

import collections
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core.cache import PendingPut, ScheduleCache  # noqa: E402
from repro_torch.core.registry import schedule_cache  # noqa: E402
from repro_torch.core.schedule import Schedule  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeConfig  # noqa: E402
from repro_torch.serve.graphs import StepGraph  # noqa: E402

MAX_LEN = 64

#: family -> (config, overrides of its smoke variant, paged, prompt lengths)
FAMILIES = {
    "dense_paged": ("qwen3-1.7b", {}, True, (5, 19, 12)),
    "dense_contiguous": ("qwen3-1.7b", {}, False, (5, 19, 12)),
    "window_ring": ("h2o-danube-1.8b", {}, False, (40, 9, 33)),
    "moe": ("dbrx-132b", {}, True, (5, 19, 12)),
    "vlm": ("llava-next-34b", {}, True, (5, 19, 12)),
    "ssm": ("mamba2-2.7b", {}, False, (5, 19, 12)),
    "hybrid": ("zamba2-7b", {}, False, (5, 19, 12)),
    "enc_dec": ("seamless-m4t-large-v2", {}, False, (5, 19, 12)),
    "padded_heads": ("qwen3-1.7b", {"padded_heads": 8}, True, (5, 19, 12)),
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_static_buffer_step_keeps_every_cache_leaf_in_place(family):
    arch, overrides, paged, lens = FAMILIES[family]
    cfg = configs.get_smoke(arch, **overrides)
    params = M.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    extra = None
    if cfg.family == "enc_dec":
        extra = {"enc_embeds": rng.standard_normal(
            (8, cfg.d_model)).astype(np.float32)}
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=MAX_LEN, capacity=3, paged=paged, page_size=8),
        example_extra=extra)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32), 6,
                   extra=extra)
    eng.step()                       # admit every request, one decode
    graph = eng.graph
    assert isinstance(graph, StepGraph) and graph.captures == 1
    assert graph.caches is eng.caches
    before = [(path, leaf.data_ptr(), leaf.shape, leaf.dtype)
              for path, leaf in _leaves(eng.caches)]
    copy = _clone(eng.caches)
    pt = active = None
    if paged:
        pt = eng._pt.copy()
        active = np.zeros(eng.capacity, bool)
        active[[s for s, _ in eng.pool.held()]] = True
    graph.logits.fill_(float("nan"))
    logits_ptr = graph.logits.data_ptr()

    got = graph.replay(eng.tokens.copy(), pt, active)
    want, _ = M.decode_step(
        params, copy, torch.as_tensor(eng.tokens.copy()), eng.cfg,
        pt=None if pt is None else torch.as_tensor(pt),
        active=None if active is None else torch.as_tensor(active))

    assert got is graph.logits and got.data_ptr() == logits_ptr
    assert torch.equal(got, want)
    assert [(path, leaf.data_ptr(), leaf.shape, leaf.dtype)
            for path, leaf in _leaves(eng.caches)] == before
    for (path, leaf), (_, ref) in zip(_leaves(eng.caches), _leaves(copy)):
        assert torch.equal(leaf, ref), path
    assert graph.captures == 1       # replays after the first build nothing


# ---------------------------------------------------- tokens against repro
FIELDS = dict(name="g", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=32, d_ff=128, vocab=128, qk_norm=True,
              dtype="float32")
SSM_FIELDS = dict(name="gm", family="ssm", n_layers=2, d_model=64,
                  n_heads=0, n_kv_heads=0, d_ff=0, vocab=128, ssm_state=16,
                  ssm_headdim=32, ssm_chunk=16, dtype="float32")
CASES = {"dense_paged": (FIELDS, dict(paged=True, page_size=8,
                                      prefill_chunk=8)),
         "dense_contiguous": (FIELDS, {}),
         "ssm": (SSM_FIELDS, {})}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    fields, scfg = CASES[request.param]
    jcfg = JConfig(**fields).validate()
    cfg = ModelConfig(**fields).validate()
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(1, cfg.vocab, n).astype(np.int32), b)
            for n, b in ((3, 5), (17, 4), (26, 6), (9, 3), (17, 7))]
    ref = jengine.Engine(jp, jcfg, jengine.ServeConfig(max_len=MAX_LEN))
    want = [ref.generate(p[None], b)[0] for p, b in reqs]
    return params, cfg, scfg, reqs, want


def _tokens(params, cfg, scfg, reqs, step_graphs):
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=MAX_LEN, capacity=3, step_graphs=step_graphs, **scfg))
    uids = [eng.submit(p, b).uid for p, b in reqs]
    out = eng.run(max_steps=1000)
    return eng, [out[u] for u in uids]


def test_graph_tokens_equal_eager_and_the_reference(case):
    params, cfg, scfg, reqs, want = case
    eng, got = _tokens(params, cfg, scfg, reqs, True)
    eager_eng, eager = _tokens(params, cfg, scfg, reqs, False)
    assert eager_eng.graph is None
    assert eng.graph is not None and eng.graph.captures == 1
    for i, (g, e, w) in enumerate(zip(got, eager, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(e, w, err_msg=f"request {i} (eager)")
    assert eng.stats == eager_eng.stats | {
        k: eng.stats[k] for k in ("prefill_s", "decode_s")}


# ---------------------------------------------------------- schedule swap
class FakeGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _commit(store: ScheduleCache) -> None:
    store.commit([PendingPut(
        kernel_name="paged_gather", signature='{"b": 1}',
        schedule=Schedule(knobs={"rows": 1, "n_chunks": 1}), energy=1e-9,
        tests_passed=True)])


def test_schedule_swap_drops_the_graph_and_the_next_decode_rebuilds_it(
        case):
    params, cfg, scfg, reqs, want = case
    store = ScheduleCache()
    with schedule_cache(store):
        eng = ContinuousEngine(params, cfg, ServeConfig(
            max_len=MAX_LEN, capacity=3, **scfg))
        handles = [eng.submit(p, b) for p, b in reqs[:3]]
        for _ in range(2):
            eng.step()
        assert eng.graph.captures == 1
        # a captured step stands where the card would hold one: the swap
        # must drop it before the next decode, which then builds anew
        fake = eng.graph.graph = FakeGraph()
        _commit(store)
        eng.step()
        assert eng.stats["schedule_swaps"] == 1
        assert fake.replays == 0 and eng.graph.graph is None
        assert eng.graph.captures == 2
        handles += [eng.submit(p, b) for p, b in reqs[3:]]
        out = eng.run(max_steps=1000)
    assert eng.graph.captures == 2
    for i, h in enumerate(handles):
        got = out.get(h.uid, h.output)
        np.testing.assert_array_equal(got, want[i], err_msg=f"request {i}")


def test_step_graphs_off_keeps_eager_dispatch(case):
    params, cfg, scfg, _, _ = case
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_len=MAX_LEN, capacity=2, step_graphs=False, **scfg))
    assert eng.graph is None
    eng._make_dispatchers()          # a swap builds nothing either
    assert eng.graph is None


# -------------------------------------------------------- launch crediting
@pytest.fixture
def fake_kernel_module(monkeypatch):
    """A kernel module with the counters the real ones keep, and a kernel
    class whose objects count their own launches."""
    mod = types.ModuleType("fake_kernel_module")
    mod.launches = 0
    mod.variant_launches = {(True, "bfloat16"): 0, (False, "bfloat16"): 0}

    class FakeKernel:
        def __init__(self):
            self.launches = 0

        def __call__(self, variant=None):
            kernels.count_launch(self, variant)

    FakeKernel.__module__ = mod.__name__
    mod.FakeKernel = FakeKernel
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def test_count_launch_records_instead_of_counting_inside_a_capture(
        fake_kernel_module):
    mod = fake_kernel_module
    a, b = mod.FakeKernel(), mod.FakeKernel()
    a()
    b((True, "bfloat16"))
    assert (mod.launches, a.launches, b.launches) == (2, 1, 1)
    assert mod.variant_launches[True, "bfloat16"] == 1
    with kernels.recording_launches() as log:
        for _ in range(3):
            a()
        b((True, "bfloat16"))
    assert (mod.launches, a.launches, b.launches) == (2, 1, 1)
    assert log == collections.Counter({(a, None): 3,
                                       (b, (True, "bfloat16")): 1})
    a()                              # counted again once the block ends
    assert (mod.launches, a.launches) == (3, 2)
    kernels.credit_launches(log)
    assert (mod.launches, a.launches, b.launches) == (7, 5, 2)
    assert mod.variant_launches == {(True, "bfloat16"): 2,
                                    (False, "bfloat16"): 0}


def test_each_replay_credits_the_captured_launches(fake_kernel_module):
    mod = fake_kernel_module
    kern = mod.FakeKernel()
    cfg = ModelConfig(**FIELDS).validate()
    params = M.init_lm(cfg, seed=0, device="cpu")
    caches = M.alloc_slot_caches(cfg, 2, MAX_LEN, device="cpu")
    graph = StepGraph(params, caches, cfg, 2, device=torch.device("cpu"))
    with kernels.recording_launches() as log:
        kern()
        kern()
        kern((False, "bfloat16"))
    graph.graph, graph.credits = FakeGraph(), log
    for _ in range(4):
        graph.replay(np.zeros(2, np.int32))
    assert graph.graph.replays == graph.replays == 4
    assert (mod.launches, kern.launches) == (12, 12)
    assert mod.variant_launches[False, "bfloat16"] == 4
    graph.drop()                     # a dropped graph credits nothing more
    assert graph.graph is None and not graph.credits
    graph.replay(np.zeros(2, np.int32))
    assert (mod.launches, kern.launches) == (12, 12)
