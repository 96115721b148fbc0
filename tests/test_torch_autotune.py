"""repro_torch.autotune against repro.autotune, on the CPU.

The cases of tests/test_autotune.py on the port (distribution staleness,
stream tailing, history warm starts and their legality, the promotion gate's
margin and permanent quarantine, batch commits, the service's full cycle,
eviction, warm starts across services, the journal round trip); a
differential: one ``run_once`` in each package over the same recorded mix
of a smoke qwen3 run promotes the same (kernel, signature, schedule) set and
journals the same event kinds; and the adapter's targets carry exactly the
signatures the port's bfloat16 paged serving path resolves (padded flash
lengths, the gather's pool geometry).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.autotune import adapters as jadapters  # noqa: E402
from repro.autotune import service as jservice  # noqa: E402
from repro.core.cache import ScheduleCache as JScheduleCache  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.autotune.adapters import (TuneTarget, _attn_args,  # noqa: E402
                                           padded_len, serve_targets)
from repro_torch.autotune.gate import PromotionGate, incumbent_energy  # noqa: E402
from repro_torch.autotune.history import (TuneHistory,  # noqa: E402
                                          feature_distance, features_of)
from repro_torch.autotune.log import (EventLog, load_events,  # noqa: E402
                                      validate_events)
from repro_torch.autotune.service import (AutotuneConfig,  # noqa: E402
                                          AutotuneService,
                                          WorkloadDistribution,
                                          _fast_tune_config, jsonl_source,
                                          recorder_source)
from repro_torch.core.cache import PendingPut, ScheduleCache  # noqa: E402
from repro_torch.core.registry import KernelSpec, Workload, registry  # noqa: E402
from repro_torch.core.schedule import KnobSpec, Schedule, SearchSpace  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pg_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs.recorder import (WorkloadKey, WorkloadRecorder,  # noqa: E402
                                      tail_jsonl)
from repro_torch.serve.engine import ContinuousEngine, ServeConfig  # noqa: E402
from repro_torch.tuning.state import SearchState  # noqa: E402

K1 = WorkloadKey(kind="prefill", prompt_len=16, batch=1, dtype="float32")
K2 = WorkloadKey(kind="prefill", prompt_len=8, batch=2, dtype="float32")


class TestWorkloadDistribution:
    def test_update_is_monotonic(self):
        """Re-delivery of an older cumulative snapshot never un-counts."""
        dist = WorkloadDistribution(half_life_s=10.0)
        dist.update({K1: (5, 2.0)})
        dist.update({K1: (3, 1.0)})          # stale: lower count, older t
        assert dist.weights(2.0)[K1] == pytest.approx(5.0)
        dist.update({K1: (9, 4.0)})
        assert dist.weights(4.0)[K1] == pytest.approx(9.0)

    def test_staleness_halves_per_half_life(self):
        dist = WorkloadDistribution(half_life_s=10.0)
        dist.update({K1: (8, 0.0), K2: (8, 10.0)})
        w = dist.weights(10.0)               # K1 is one half-life stale
        assert w[K1] == pytest.approx(4.0)
        assert w[K2] == pytest.approx(8.0)
        shares = dist.shares(10.0)
        assert sum(shares.values()) == pytest.approx(1.0)
        assert shares[K2] == pytest.approx(2 * shares[K1])

    def test_empty_shares(self):
        assert WorkloadDistribution().shares(0.0) == {}


class TestStreamTailing:
    def test_tail_leaves_partial_line(self, tmp_path):
        p = str(tmp_path / "mix.jsonl")
        full = json.dumps({"kind": "prefill", "t": 1.0}) + "\n"
        with open(p, "w") as f:
            f.write(full * 2 + '{"kind": "pre')     # torn mid-write
        recs, off = tail_jsonl(p, 0)
        assert len(recs) == 2 and off == 2 * len(full)
        with open(p, "a") as f:                      # writer finishes the line
            f.write('fill", "t": 2.0}\n')
        recs, off2 = tail_jsonl(p, off)
        assert len(recs) == 1 and recs[0]["t"] == 2.0
        assert tail_jsonl(p, off2) == ([], off2)     # drained

    def test_tail_missing_file_and_corrupt_line(self, tmp_path):
        assert tail_jsonl(str(tmp_path / "nope.jsonl"), 0) == ([], 0)
        p = str(tmp_path / "mix.jsonl")
        with open(p, "w") as f:
            f.write('not json\n' + json.dumps({"kind": "decode"}) + "\n")
        recs, _ = tail_jsonl(p, 0)
        assert [r["kind"] for r in recs] == ["decode"]

    def test_jsonl_source_accumulates_cumulative_snapshot(self, tmp_path):
        p = str(tmp_path / "mix.jsonl")
        src = jsonl_source(p)
        assert src() == ({}, 0.0)
        rec = {"kind": "prefill", "prompt_len": 16, "batch": 1,
               "dtype": "float32"}
        with open(p, "w") as f:
            f.write(json.dumps({**rec, "t": 1.0}) + "\n")
        snap, now = src()
        assert snap[K1] == (1, 1.0) and now == 1.0
        with open(p, "a") as f:
            f.write(json.dumps({**rec, "t": 3.0}) + "\n")
        snap, now = src()
        assert snap[K1] == (2, 3.0) and now == 3.0   # cumulative, not delta


SPACE = SearchSpace(knobs=(KnobSpec("bq", (4, 8)), KnobSpec("bk", (4, 8))))
FEATS_16 = features_of({"sq": 16, "dtype": "float32"})
FEATS_8 = features_of({"sq": 8, "dtype": "float32"})


def _hist_record(hist, *, sig="s16", feats=FEATS_16, knobs=None, order=None,
                 accepted=True, improvement=0.1):
    hist.record(kernel="k", signature=sig, workload="w",
                schedule=Schedule(knobs=knobs or {"bq": 8, "bk": 4},
                                  order=order),
                energy=1.0, improvement=improvement, accepted=accepted,
                features=feats)


class TestTuneHistory:
    def test_roundtrip_and_corrupt_degrade(self, tmp_path):
        p = str(tmp_path / "hist.json")
        hist = TuneHistory(p)
        _hist_record(hist)
        again = TuneHistory(p)
        assert len(again) == 1 and again.records[0].kernel == "k"
        with open(p, "w") as f:
            f.write("{broken")
        assert len(TuneHistory(p)) == 0              # loud would kill service

    def test_file_is_the_reference_format(self, tmp_path):
        """A history written by either package loads in the other."""
        from repro.autotune.history import TuneHistory as JTuneHistory
        p = str(tmp_path / "hist.json")
        _hist_record(TuneHistory(p), order=(1, 0, 2))
        got = JTuneHistory(p).warm_start("k", "s16", SPACE, FEATS_16)
        assert got is not None and got.order == (1, 0, 2)

    def test_warm_start_exact_signature_keeps_order(self):
        hist = TuneHistory()
        _hist_record(hist, order=(1, 0, 2))
        got = hist.warm_start("k", "s16", SPACE, FEATS_16)
        assert got is not None and got.order == (1, 0, 2)

    def test_warm_start_neighbor_strips_order(self):
        """Orders index a specific program's instructions — a cross-shape
        recall must drop them or the target kernel would mis-apply it."""
        hist = TuneHistory()
        _hist_record(hist, sig="s16", feats=FEATS_16, order=(1, 0, 2))
        got = hist.warm_start("k", "s8", SPACE, FEATS_8)
        assert got is not None and got.order is None
        assert got.knobs == {"bq": 8, "bk": 4}       # knobs do transfer

    def test_warm_start_nearest_neighbor_wins(self):
        hist = TuneHistory()
        _hist_record(hist, sig="s16", feats=FEATS_16, knobs={"bq": 8})
        far = features_of({"sq": 4096, "dtype": "bfloat16"})
        _hist_record(hist, sig="sfar", feats=far, knobs={"bq": 4})
        got = hist.warm_start("k", "s8", SPACE, FEATS_8)
        assert got.knobs == {"bq": 8}                # s16 is nearer than sfar
        assert feature_distance(FEATS_8, FEATS_16) < \
            feature_distance(FEATS_8, far)

    def test_warm_start_filters_illegal_and_unaccepted(self):
        hist = TuneHistory()
        _hist_record(hist, knobs={"bq": 999})            # not in SPACE
        _hist_record(hist, knobs={"bq": 4}, accepted=False)
        assert hist.warm_start("k", "s16", SPACE, FEATS_16) is None
        assert hist.warm_start("other", "s16", SPACE, FEATS_16) is None

    def test_greed_fits_per_kernel(self):
        hist = TuneHistory()
        for _ in range(8):
            _hist_record(hist, improvement=0.4)
        assert hist.greed_for("k") > 0.5             # wins -> greedier
        assert hist.greed_for("unseen", default=0.7) == 0.7

    @given(st.integers(0, 2 ** 31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_warm_start_is_always_legal_for_target_space(self, seed):
        """THE safety property: whatever junk history holds, a warm start is
        always a point of the TARGET kernel's knob space, and carries an
        instruction order only on an exact signature match."""
        rng = np.random.default_rng(seed)
        hist = TuneHistory()
        for i in range(int(rng.integers(1, 6))):
            knobs = {f"n{j}": int(rng.integers(0, 6))
                     for j in range(int(rng.integers(0, 4)))}
            order = (tuple(int(x) for x in rng.permutation(3))
                     if rng.random() < 0.5 else None)
            _hist_record(hist, sig=f"s{int(rng.integers(0, 3))}",
                         feats={"x": float(rng.random())}, knobs=knobs,
                         order=order, accepted=bool(rng.random() < 0.8))
        target = SearchSpace(knobs=tuple(
            KnobSpec(f"n{j}", tuple(range(int(rng.integers(1, 5)))))
            for j in range(int(rng.integers(0, 4)))))
        sig = f"s{int(rng.integers(0, 3))}"
        got = hist.warm_start("k", sig, target, {"x": 0.5})
        if got is not None:
            assert target.contains(got.knobs)
            if got.order is not None:
                recs = [r for r in hist.records
                        if r.accepted and r.signature == sig]
                assert any(Schedule.from_json(r.schedule_json).order
                           == got.order for r in recs)


def _fake_spec(name="fake_id"):
    """Identity kernel whose schedule can be wrong on purpose: the bad=1
    knob adds 1.0, so verification against the identity oracle fails."""
    space = SearchSpace(knobs=(KnobSpec("bad", (0, 1)),))

    def build(schedule, **static):
        off = float(schedule.knobs.get("bad", 0))
        return lambda x: np.asarray(x) + off
    return KernelSpec(name=name, build=build,
                      program_for=lambda s, **st_: None,
                      space_for=lambda **st_: space,
                      oracle=lambda x: np.asarray(x),
                      signature_fn=lambda x: {"n": int(np.asarray(x).shape[0])})


WL = Workload(name="w",
              make_args=lambda rng: [rng.standard_normal(8).astype(np.float32)],
              suites=("live",))


class TestPromotionGate:
    def test_untuned_key_promotes_on_verify(self):
        gate = PromotionGate(ScheduleCache(), samples=4, device="cpu")
        d = gate.evaluate(_fake_spec(), WL, "sig", Schedule(knobs={"bad": 0}),
                          1.0)
        assert d.promoted and d.reason == "promoted" and d.samples == 4
        assert d.incumbent_energy is None

    def test_margin_vs_incumbent(self):
        live = ScheduleCache()
        live.put("fake_id", "sig", Schedule(knobs={"bad": 0}), 1.0,
                 tests_passed=True)
        assert incumbent_energy(live, "fake_id", "sig") == 1.0
        gate = PromotionGate(live, margin=0.05, samples=2, device="cpu")
        close = gate.evaluate(_fake_spec(), WL, "sig",
                              Schedule(knobs={"bad": 0}), 0.97)
        assert not close.promoted and close.reason == "insufficient_margin"
        clear = gate.evaluate(_fake_spec(), WL, "sig",
                              Schedule(knobs={"bad": 0}), 0.90)
        assert clear.promoted

    def test_failing_schedule_quarantined_and_never_promoted(self, tmp_path):
        """A wrong-output candidate is quarantined, journaled, and
        permanently blocked — even across a state reload, and even if it
        later shows up with a winning energy."""
        state = SearchState(path=str(tmp_path / "state.json"))
        live = ScheduleCache()
        gate = PromotionGate(live, samples=4, state=state, device="cpu")
        bad = Schedule(knobs={"bad": 1})
        d1 = gate.evaluate(_fake_spec(), WL, "sig", bad, 1e-9)
        assert not d1.promoted and d1.reason == "verify_failed"
        assert d1.max_err >= 1.0
        assert live.version == 0                     # gate never touches live
        d2 = gate.evaluate(_fake_spec(), WL, "sig", bad, 1e-12)
        assert not d2.promoted and d2.reason == "quarantined_prior"
        reloaded = SearchState.load(str(tmp_path / "state.json"))
        gate2 = PromotionGate(live, samples=4, state=reloaded, device="cpu")
        d3 = gate2.evaluate(_fake_spec(), WL, "sig", bad, 1e-12)
        assert not d3.promoted and d3.reason == "quarantined_prior"
        assert incumbent_energy(live, "fake_id", "sig") is None

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="margin"):
            PromotionGate(ScheduleCache(), margin=-0.1, device="cpu")
        with pytest.raises(ValueError, match="samples"):
            PromotionGate(ScheduleCache(), samples=0, device="cpu")


class TestBatchCommit:
    def test_commit_bumps_version_once(self, tmp_path):
        cache = ScheduleCache(str(tmp_path / "c.json"))
        v0 = cache.version
        cache.commit([PendingPut(kernel_name="k", signature=f"s{i}",
                                 schedule=Schedule(), energy=1.0,
                                 tests_passed=True) for i in range(3)])
        assert cache.version == v0 + 1
        assert not cache.changed_since(cache.version)
        assert cache.changed_since(v0)
        assert len(ScheduleCache(str(tmp_path / "c.json"))._data) == 3

    def test_empty_commit_is_a_noop(self):
        cache = ScheduleCache()
        v0 = cache.version
        cache.commit([])
        assert cache.version == v0 and not cache.changed_since(v0)


# ---------------------------------------------------------------- e2e cycle
ATTN = dict(b=1, hq=2, hkv=2, s=16, d=8)


def _attn_target(key):
    name = fa_ops.ensure_registered(causal=True, window=None)
    return TuneTarget(name, Workload(
        name=key.name,
        make_args=_attn_args(key.batch, ATTN["hq"], ATTN["hkv"],
                             key.prompt_len, ATTN["d"]),
        suites=("live",)))


def _service(live, source, **over):
    history = over.pop("history", None)
    cfg = AutotuneConfig(budget=over.pop("budget", 2), samples=2,
                         interval_s=1.0, share_floor=0.2,
                         tune=_fast_tune_config(), **over)
    return AutotuneService(live, source=source, target_for=_attn_target,
                           config=cfg, history=history, device="cpu")


class TestServiceCycle:
    def test_full_cycle_promotes_with_one_version_bump(self):
        keys = {K1: (10, 1.0), K2: (6, 1.0)}
        svc = _service(ScheduleCache(), lambda: (keys, 2.0))
        v0 = svc.live.version
        summary = svc.run_once()
        assert summary["tuned"] == 2 and summary["promoted"] == 2
        # both promotions landed in ONE commit -> ONE engine swap
        assert svc.live.version == v0 + 1
        for key in (K1, K2):
            kernel, sig = svc._promoted[key]
            assert svc.live.best(kernel, sig) is not None
        assert svc.metrics()["promotions"] == 2
        assert validate_events(svc.log.events) == []
        kinds = [e["kind"] for e in svc.log.events]
        assert kinds.count("tuned") == 2 and kinds[-1] == "cycle"
        assert len(svc.history) == 2                 # both gated runs journal

    def test_eviction_below_share_floor(self):
        feed = {"now": 2.0, "keys": {K1: (10, 1.0), K2: (10, 1.0)}}
        svc = _service(ScheduleCache(),
                       lambda: (feed["keys"], feed["now"]), budget=2)
        svc.run_once()
        assert len(svc._promoted) == 2
        # K2 goes quiet for many half-lives; K1 keeps firing
        feed["keys"] = {K1: (500, 5000.0), K2: (10, 1.0)}
        feed["now"] = 5000.0
        summary = svc.run_once()
        assert summary["evicted"] == 1
        assert K2 not in svc._promoted and K1 in svc._promoted
        kernel, sig = svc._promoted[K1]
        assert svc.live.best(kernel, sig) is not None
        assert svc.metrics()["evictions"] == 1
        assert any(e["kind"] == "evicted" for e in svc.log.events)

    def test_warm_start_hits_across_services(self, tmp_path):
        hist = TuneHistory(str(tmp_path / "hist.json"))
        svc1 = _service(ScheduleCache(), lambda: ({K1: (10, 1.0)}, 2.0),
                        budget=1, history=hist)
        svc1.run_once()
        assert svc1.metrics()["warm_start_hits"] == 0
        # a fresh service (new session) over the SAME history warm-starts
        svc2 = _service(ScheduleCache(),
                        lambda: ({K1: (10, 1.0)}, 2.0), budget=1,
                        history=TuneHistory(str(tmp_path / "hist.json")))
        svc2.run_once()
        assert svc2.metrics()["warm_start_hits"] == 1
        assert any(e["kind"] == "warm_start" for e in svc2.log.events)

    def test_unmappable_keys_skipped_once(self):
        sub = WorkloadKey(kind="submit", prompt_len=0, batch=1, dtype="int32")
        calls = []

        def target_for(key):
            calls.append(key)
            return None
        svc = AutotuneService(
            ScheduleCache(), source=lambda: ({sub: (5, 1.0)}, 2.0),
            target_for=target_for,
            config=AutotuneConfig(samples=2, tune=_fast_tune_config()),
            device="cpu")
        assert svc.run_once()["candidates"] == 0
        assert svc.run_once()["candidates"] == 0
        assert calls == [sub]                        # never re-asked

    def test_worker_thread_runs_cycles_until_stopped(self):
        svc = _service(ScheduleCache(), lambda: ({K1: (10, 1.0)}, 2.0),
                       budget=1)
        svc.start()
        with pytest.raises(RuntimeError, match="already started"):
            svc.start()
        svc.stop(timeout=60)
        assert svc._thread is None
        assert svc.metrics()["cycles"] >= 1 and svc.metrics()["errors"] == 0
        assert svc.metrics()["promotions"] == 1

    def test_service_refuses_cuda_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            AutotuneService(ScheduleCache(), source=lambda: ({}, 0.0),
                            target_for=_attn_target)

    def test_event_log_journal_roundtrip(self, tmp_path):
        p = str(tmp_path / "events.jsonl")
        with EventLog(p) as log:
            log.emit("cycle", cycle=1, candidates=0, tuned=0, promoted=0,
                     quarantined=0)
            with pytest.raises(ValueError, match="unknown autotune event"):
                log.emit("nonsense")
        events = load_events(p)
        assert validate_events(events) == []
        assert validate_events([{"kind": "promoted", "t": 1.0}]) != []


# ------------------------------------------------ differential vs repro
#: a smoke qwen3 run whose prompt lengths are multiples of the port's
#: causal-flash tile (64), so each prefill key names the same flash
#: signature in both packages (the port pads other lengths up to it; that
#: mapping is held by test_adapter_signatures_are_the_ones_serving_resolves)
PLENS = (64, 64, 128, 64)
SCFG = dict(max_len=192, capacity=2, paged=True, page_size=16,
            prefill_chunk=64)


@pytest.fixture(scope="module")
def recorded_mix(tmp_path_factory):
    cfg = configs.get_smoke("qwen3-1.7b")
    params = M.init_lm(cfg, seed=0, device="cpu")
    path = str(tmp_path_factory.mktemp("mix") / "live.jsonl")
    rec = WorkloadRecorder(path)
    eng = ContinuousEngine(params, cfg, ServeConfig(**SCFG), recorder=rec)
    rng = np.random.default_rng(0)
    for n in PLENS:
        eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32), 6)
    eng.run(max_steps=1000)
    rec.close()
    return path


def test_run_once_promotes_what_the_reference_promotes(recorded_mix):
    """One cycle in each package over the same recorded mix, with the
    cost-model energy and the same seed: the same promoted (kernel,
    signature, schedule) set and the same journal event kinds."""
    from repro import kernels as jkernels
    from repro import configs as jconfigs
    jkernels.load_all()
    kernels.load_all()
    cfg = configs.get_smoke("qwen3-1.7b")
    jsvc = jservice.AutotuneService(
        JScheduleCache(), source=jservice.jsonl_source(recorded_mix),
        target_for=jadapters.serve_targets(
            jconfigs.get_smoke("qwen3-1.7b"), jengine.ServeConfig(**SCFG)),
        config=jservice.AutotuneConfig(budget=2, samples=2))
    svc = AutotuneService(
        ScheduleCache(), source=jsonl_source(recorded_mix),
        target_for=serve_targets(cfg, ServeConfig(**SCFG)),
        config=AutotuneConfig(budget=2, samples=2), device="cpu")
    got, want = svc.run_once(), jsvc.run_once()
    assert got["promoted"] == want["promoted"] == 2

    def promoted(log):
        return sorted((e["kernel"], e["signature"], e["schedule_sig"])
                      for e in log.events if e["kind"] == "promoted")
    assert promoted(svc.log) == promoted(jsvc.log)
    assert {k for k, *_ in promoted(svc.log)} == {
        "flash_attention_causal", "paged_gather"}
    assert [e["kind"] for e in svc.log.events] == \
        [e["kind"] for e in jsvc.log.events]
    assert validate_events(svc.log.events) == []
    flash = [json.loads(e["schedule_sig"]) for e in svc.log.events
             if e["kind"] == "promoted"
             and e["kernel"] == "flash_attention_causal"]
    assert flash[0]["order"] is not None          # a searched order


def test_recorder_source_drains_a_live_recorder():
    rec = WorkloadRecorder()
    rec.record("decode", batch=4, dtype="float32", occupancy=3)
    rec.record("decode", batch=4, dtype="float32", occupancy=2)
    snap, now = recorder_source(rec)()
    key = WorkloadKey(kind="decode", prompt_len=0, batch=4, dtype="float32")
    assert snap[key][0] == 2 and now >= snap[key][1]


# ---------------------------------------- adapter vs the serving path
BF16 = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab=128,
                   dtype="bfloat16").validate()


def test_adapter_signatures_are_the_ones_serving_resolves(monkeypatch):
    """Serve bf16 on the paged engine with prompts of lengths that are not
    multiples of the flash tile, recording the signature of every flash
    and gather call the kernels would resolve (through the model's own
    padding); every key's target must name one of them."""
    served = {"flash_attention_causal": [], "paged_gather": []}
    flash_spec = registry.spec(fa_ops.ensure_registered(True, None))

    def flash_spy(q, k, v, *, causal=True, window=None):
        def kern(q2, k2, v2, **kw):
            served["flash_attention_causal"].append(
                flash_spec.signature_fn(q2, k2, v2))
            return fa_ref.attention(q2, k2, v2, causal=causal, window=window)
        return fa_kernel.padded(kern, q, k, v, causal=causal)

    gather = pg_kernel.paged_gather

    def gather_spy(store, pt):
        served["paged_gather"].append(pg_ops.signature_fn(store, pt))
        return gather(store, pt)

    monkeypatch.setattr(fa_kernel, "flash_attention", flash_spy)
    monkeypatch.setattr(pg_kernel, "paged_gather", gather_spy)
    scfg = ServeConfig(max_len=96, capacity=3, paged=True, page_size=16,
                       prefix_cache=False)
    params = M.init_lm(BF16, seed=0, device="cpu")
    rec = WorkloadRecorder()
    eng = ContinuousEngine(params, BF16, scfg, recorder=rec)
    rng = np.random.default_rng(1)
    for n in (20, 37, 20, 70):
        eng.submit(rng.integers(0, BF16.vocab, n).astype(np.int32), 5)
    eng.run(max_steps=1000)

    target_for = serve_targets(BF16, scfg)
    checked = set()
    for key in rec.mix():
        tgt = target_for(key)
        if tgt is None:
            assert key.kind == "submit"
            continue
        spec = registry.spec(tgt.kernel)
        args = tgt.workload.tensors(np.random.default_rng(0))
        sig = spec.signature_fn(*args)
        assert sig in served[tgt.kernel], (key, sig)
        assert sig["dtype"] == "bfloat16"
        checked.add(tgt.kernel)
        if tgt.kernel == "flash_attention_causal":
            assert sig["sq"] == sig["skv"] == padded_len(key.prompt_len)
            assert sig["sq"] % fa_kernel.SEQ_TILE == 0
        else:
            assert sig == {"p": 3 * 6 + 1, "ps": 16, "h": 2, "d": 32,
                           "b": 3, "n": 6, "dtype": "bfloat16"}
    assert checked == set(served)
    # the naive copy of the reference's adapter tunes a signature nothing
    # serves: float32 draws at the key's own length
    naive = jadapters._attn_args(1, 4, 2, 20, 32, "float32")(
        np.random.default_rng(0))
    assert flash_spec.signature_fn(*[torch.from_numpy(a) for a in naive]) \
        not in served["flash_attention_causal"]
