"""Mid-stream schedule hot-swap in the port's engine, against repro's tokens.

A running ContinuousEngine polls its schedule store's version before every
dispatch; a commit (an autotune promotion) counts one ``schedule_swaps``,
restarts the compile accounting and rebuilds the dispatchers, and the next
kernel call resolves the new schedule.  These tests promote a legal
non-default flash schedule at the (padded) prefill signature WHILE requests
are in flight and hold greedy outputs token-identical to repro's
single-request generation on the same weights — contiguous and paged.  On
the CPU the model's kernels take their plain versions, so what resolves is
shown through the registry kernel itself; the card's run
(``chip_smoke.py``, ``autotune`` phase) shows the swapped kernel launching.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.cache import PendingPut, ScheduleCache  # noqa: E402
from repro_torch.core.registry import registry, schedule_cache  # noqa: E402
from repro_torch.core.schedule import Schedule  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeConfig  # noqa: E402

FIELDS = dict(name="hs", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, dtype="float32")
JCFG = JConfig(**FIELDS).validate()
CFG = ModelConfig(**FIELDS).validate()
MAX_LEN = 32
PLEN = 16
HD = CFG.d_model // CFG.n_heads


@pytest.fixture(scope="module")
def params():
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), JCFG))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                 device="cpu")


@pytest.fixture(scope="module")
def reference(params):
    """repro's single-request generation — outputs must be identical before
    AND after the swap."""
    jp, _ = params
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, CFG.vocab, PLEN).astype(np.int32),
             int(rng.integers(4, 9))) for _ in range(4)]
    ref = jengine.Engine(jp, JCFG, jengine.ServeConfig(max_len=MAX_LEN))
    want = [ref.generate(p[None], n)[0] for p, n in reqs]
    return reqs, want


def _prefill_static() -> tuple[str, dict]:
    """The flash signature the engine's prefill resolves: (1, H, PLEN, hd)
    padded to the kernel's sequence tile."""
    name = fa_ops.ensure_registered(causal=True, window=None)
    s = -(-PLEN // fa_kernel.SEQ_TILE) * fa_kernel.SEQ_TILE
    ex = [torch.zeros(1, CFG.n_heads, s, HD)] * 3
    return name, registry.spec(name).signature_fn(*ex)


def _promote_prefill_schedule(store: ScheduleCache) -> Schedule:
    """Commit a legal NON-default schedule for the exact prefill signature
    the engine dispatches — an autotune promotion."""
    name, static = _prefill_static()
    space = registry.spec(name).space_for(**static)
    knobs = {k.name: k.choices[-1] for k in space.knobs}
    sched = Schedule(knobs=knobs)
    assert knobs != space.default_knobs(), "swap must change the schedule"
    store.commit([PendingPut(kernel_name=name,
                             signature=registry.get(name, store).sig_str(
                                 static),
                             schedule=sched, energy=1e-9, tests_passed=True,
                             meta={"autotune": True})])
    return sched


def _run_with_midstream_swap(params, reqs, scfg):
    _, tp = params
    store = ScheduleCache()
    with schedule_cache(store):
        eng = ContinuousEngine(tp, CFG, scfg)
        handles = [eng.submit(*reqs[j]) for j in (0, 1)]
        for _ in range(3):                   # first two requests in flight
            eng.step()
        v0 = store.version
        _promote_prefill_schedule(store)     # the hot-swap commit
        assert store.changed_since(v0)
        handles += [eng.submit(*reqs[j]) for j in (2, 3)]
        out = eng.run(max_steps=10_000)
    return eng, [out[h.uid] for h in handles]


class TestHotSwapDifferential:
    @pytest.mark.parametrize("paged", [False, True],
                             ids=["contiguous", "paged"])
    def test_token_identical_across_swap(self, params, reference, paged):
        reqs, want = reference
        scfg = (ServeConfig(max_len=MAX_LEN, capacity=2, paged=True,
                            page_size=8) if paged
                else ServeConfig(max_len=MAX_LEN, capacity=2))
        eng, got = _run_with_midstream_swap(params, reqs, scfg)
        assert eng.stats["schedule_swaps"] == 1
        for j in range(len(reqs)):
            np.testing.assert_array_equal(got[j], want[j],
                                          err_msg=f"request {j}")

    def test_swap_restarts_compile_accounting_and_marks_the_trace(
            self, params, reference):
        reqs, _ = reference
        _, tp = params
        store = ScheduleCache()
        tracer = obs.Tracer()
        with schedule_cache(store), obs.tracing(tracer):
            eng = ContinuousEngine(tp, CFG, ServeConfig(max_len=MAX_LEN,
                                                        capacity=2))
            eng.submit(*reqs[0])
            eng.run(max_steps=10_000)
            assert eng.stats["prefill_compiles"] == 1
            _promote_prefill_schedule(store)
            eng.submit(*reqs[1])             # same shape: compiles again
            eng.run(max_steps=10_000)
        assert eng.stats["prefill_compiles"] == 2
        swaps = [e for e in tracer.events()
                 if e["name"] == "serve.schedule_swap"]
        assert len(swaps) == 1 and swaps[0]["args"]["version"] == 1

    def test_swapped_schedule_resolves(self, params):
        """After the swap the registry kernel the engine dispatches through
        serves the promoted schedule at the padded signature (on CPU
        tensors it runs that schedule's torch face, equal to the plain
        version)."""
        _, tp = params
        store = ScheduleCache()
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, CFG.vocab, PLEN).astype(np.int32)
        with schedule_cache(store):
            eng = ContinuousEngine(tp, CFG,
                                   ServeConfig(max_len=MAX_LEN, capacity=1))
            h1 = eng.submit(prompt, 4)
            out1 = eng.run(max_steps=10_000)[h1.uid]
            sched = _promote_prefill_schedule(store)
            h2 = eng.submit(prompt, 4)       # re-prefills through the swap
            out2 = eng.run(max_steps=10_000)[h2.uid]
            np.testing.assert_array_equal(out1, out2)
            name, static = _prefill_static()
            kern = fa_ops.kernel(True, None)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (1, CFG.n_heads, PLEN, HD)).astype(np.float32))
                for _ in range(3))
            got = fa_kernel.padded(kern, q, k, v, causal=True)
            assert kern._resolved_version == store.version
            assert kern.served_signatures() == [static]
            assert kern.schedule_for(static).knobs == sched.knobs
            torch.testing.assert_close(
                got, fa_ref.attention(q, k, v, causal=True),
                rtol=1e-5, atol=1e-5)
        assert eng.stats["schedule_swaps"] == 1

    def test_no_swap_without_commit(self, params, reference):
        reqs, _ = reference
        _, tp = params
        with schedule_cache(ScheduleCache()):
            eng = ContinuousEngine(tp, CFG,
                                   ServeConfig(max_len=MAX_LEN, capacity=2))
            for j in range(2):
                eng.submit(*reqs[j])
            eng.run(max_steps=10_000)
        assert eng.stats["schedule_swaps"] == 0

    def test_no_store_no_swap(self, params, reference):
        """An engine built outside any schedule_cache scope has no store to
        watch."""
        reqs, _ = reference
        _, tp = params
        eng = ContinuousEngine(tp, CFG, ServeConfig(max_len=MAX_LEN,
                                                    capacity=2))
        eng.submit(*reqs[0])
        eng.run(max_steps=10_000)
        assert eng.stats["schedule_swaps"] == 0


class TestMidStepPromotion:
    def test_commit_during_emission_swaps_same_step(self, params, reference):
        """The store version is polled at EVERY dispatch site, not just the
        top of step(): a commit landing from an on_token callback during
        the admission prefill's emission is picked up by the SAME step's
        decode dispatch."""
        reqs, want = reference
        _, tp = params
        store = ScheduleCache()
        committed = []

        def promote_once(req, tok):
            if not committed:
                committed.append(tok)
                _promote_prefill_schedule(store)

        with schedule_cache(store):
            eng = ContinuousEngine(tp, CFG,
                                   ServeConfig(max_len=MAX_LEN, capacity=2),
                                   on_token=promote_once)
            h = eng.submit(*reqs[0])
            eng.step()   # prefill emits -> callback commits -> decode polls
            assert committed, "first token never emitted"
            assert eng.stats["schedule_swaps"] == 1, \
                "mid-step commit not picked up within the same step"
            out = eng.run(max_steps=10_000)
        np.testing.assert_array_equal(out[h.uid], want[0])


class TestPagedObsWiring:
    def test_pool_and_prefix_metrics_registered(self, params, reference):
        reqs, _ = reference
        _, tp = params
        reg = obs.MetricsRegistry()
        eng = ContinuousEngine(tp, CFG,
                               ServeConfig(max_len=MAX_LEN, capacity=2,
                                           paged=True, page_size=8),
                               obs=reg)
        # shared prefix: the same prompt resubmitted AFTER its first prefill
        # landed in the cache -> a hit on the second pass
        eng.submit(*reqs[0])
        for _ in range(2):
            eng.step()
        eng.submit(*reqs[0])
        eng.submit(*reqs[1])
        eng.run(max_steps=10_000)
        snap = reg.snapshot()
        for name in ("serve.page_pool.occupancy", "serve.page_pool.alloc_pages",
                     "serve.page_pool.freed_pages", "serve.prefix_cache.hits",
                     "serve.prefix_cache.misses", "serve.prefix_cache.entries",
                     "serve.prefix_cache.evictions", "serve.schedule_swaps"):
            assert name in snap, f"missing metric {name}"
        assert snap["serve.page_pool.alloc_pages"]["value"] > 0
        assert snap["serve.prefix_cache.hits"]["value"] >= 1
        assert snap["serve.prefix_cache.misses"]["value"] >= 1
        assert snap["serve.page_pool.occupancy"]["value"] < 1.0
