"""The port's fault-tolerance layer, case for case as tests/test_ft_chaos.py
holds the reference's: chaos harness, supervisor recovery, and the
chaos-differential gate (an injected failure must not change what the model
learns — kill→restart runs finish with the uninterrupted final loss), all
against the port's ``train`` on the CPU."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import DataConfig
from repro_torch.ft import (Action, ChaosEngine, Fault, FaultPlan, FTConfig,
                      FTManager, NonFiniteLossError, ReshapeRequired,
                      RestartBudgetExhausted, RestartRequired, Supervisor,
                      SupervisorConfig, WorkerKilled)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, train

TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                   dtype="float32")


def _cfgs(tmp_path, steps=10, ckpt_every=4):
    dcfg = DataConfig(global_batch=2, seq_len=16, vocab=TINY.vocab)
    tcfg = TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path), log_every=1000, device="cpu")
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=steps)
    return dcfg, tcfg, ocfg


class TestFaultPlan:
    def test_parse_grammar(self):
        plan = FaultPlan.parse(
            "crash@7, kill@10:w2:perm, straggle@3:w1:x4:d5, "
            "nan@12:sticky, corrupt@5:bitflip")
        kinds = [f.kind for f in plan]
        assert kinds == ["crash", "kill", "straggle", "nan", "corrupt"]
        crash, kill, strag, nan, corrupt = plan.faults
        assert crash.step == 7
        assert (kill.worker, kill.permanent) == (2, True)
        assert (strag.worker, strag.factor, strag.duration) == (1, 4.0, 5)
        assert nan.sticky
        assert corrupt.mode == "bitflip"

    def test_spec_roundtrip(self):
        spec = "crash@7,kill@10:w2:perm,straggle@3:w1:x4:d5,nan@12:sticky," \
               "corrupt@5:bitflip"
        plan = FaultPlan.parse(spec)
        assert FaultPlan.parse(plan.to_spec()) == plan

    def test_parse_errors(self):
        with pytest.raises(ValueError, match="missing '@step'"):
            FaultPlan.parse("crash")
        with pytest.raises(ValueError, match="not an int"):
            FaultPlan.parse("crash@soon")
        with pytest.raises(ValueError, match="unknown option"):
            FaultPlan.parse("crash@3:q9")
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultPlan.parse("meteor@3")
        with pytest.raises(ValueError, match="empty fault spec"):
            FaultPlan.parse(" , ")
        with pytest.raises(ValueError, match="total_steps"):
            FaultPlan.parse("random:3")

    def test_random_is_deterministic(self):
        a = FaultPlan.random(7, total_steps=100, n_workers=4)
        b = FaultPlan.random(7, total_steps=100, n_workers=4)
        assert a == b
        assert a != FaultPlan.random(8, total_steps=100, n_workers=4)
        assert all(0 < f.step < 100 for f in a)
        # the CLI spelling resolves to the same plan
        assert FaultPlan.parse("random:7", n_workers=4, total_steps=100) == a

    def test_fault_validation(self):
        with pytest.raises(ValueError, match="unknown corrupt mode"):
            Fault(kind="corrupt", step=3, mode="gently")
        with pytest.raises(ValueError, match=">= 0"):
            Fault(kind="crash", step=-1)


class TestChaosEngine:
    def test_crash_fires_exactly_once(self):
        eng = ChaosEngine(FaultPlan.parse("crash@5"))
        for s in range(5):
            eng.on_step_start(s)
        with pytest.raises(WorkerKilled) as ei:
            eng.on_step_start(5)
        assert ei.value.step == 5
        eng.on_attempt_start()              # supervisor relaunches
        eng.on_step_start(5)                # replayed step: no re-kill
        assert len(eng.events) == 1

    def test_transient_kill_rejoins_permanent_does_not(self):
        eng = ChaosEngine(FaultPlan.parse("kill@2:w1,kill@3:w2:perm"))
        for s in range(4):
            eng.on_step_start(s)
        assert eng.heartbeat_suppressed(1) and eng.heartbeat_suppressed(2)
        eng.on_attempt_start()
        assert not eng.heartbeat_suppressed(1)      # transient came back
        assert eng.heartbeat_suppressed(2)          # permanent did not

    def test_straggler_window(self):
        eng = ChaosEngine(FaultPlan.parse("straggle@4:w1:x3:d2"))
        assert eng.latency_factor(1, 3) == 1.0
        assert eng.latency_factor(1, 4) == 3.0
        assert eng.latency_factor(1, 5) == 3.0
        assert eng.latency_factor(1, 6) == 1.0      # window closed
        assert eng.latency_factor(0, 4) == 1.0      # other workers untouched

    def test_oneshot_nan_fires_once(self):
        eng = ChaosEngine(FaultPlan.parse("nan@3"))
        assert np.isnan(eng.filter_loss(3, 1.0))
        assert eng.filter_loss(3, 1.0) == 1.0       # replay after rollback

    def test_sticky_nan_keyed_to_original_batch(self):
        """A sticky nan models a genuinely bad batch: it re-fires whenever
        step N's original batch is used, and only the supervisor's
        skip-window substitution makes progress possible."""
        eng = ChaosEngine(FaultPlan.parse("nan@3:sticky"))
        assert np.isnan(eng.filter_loss(3, 1.0))
        assert np.isnan(eng.filter_loss(3, 1.0))            # still bad
        assert eng.filter_loss(3, 1.0, substituted=True) == 1.0

    def test_corrupt_targets_first_ckpt_at_or_after_step(self, tmp_path):
        from repro_torch.checkpoint.ckpt import CheckpointManager
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(4, {"w": torch.arange(8.0)})
        eng = ChaosEngine(FaultPlan.parse("corrupt@3"))
        assert not eng.wants_corrupt(2)
        assert eng.wants_corrupt(4)
        eng.corrupt_checkpoint(str(tmp_path), 4)
        assert not mgr.verify(4)
        assert not eng.wants_corrupt(8)             # fired once


class TestFTManagerConfig:
    def test_default_config_not_shared(self):
        """Regression: ``cfg: FTConfig = FTConfig()`` in the signature made
        every default-constructed manager share ONE mutable config — tuning
        a knob on one silently retuned all of them."""
        a, b = FTManager(n_workers=2), FTManager(n_workers=2)
        assert a.cfg is not b.cfg
        a.cfg.heartbeat_timeout_s = 1e-9
        assert b.cfg.heartbeat_timeout_s == FTConfig().heartbeat_timeout_s

    def test_refresh_resets_liveness_not_restarts(self):
        t = [0.0]
        ft = FTManager(n_workers=2, cfg=FTConfig(heartbeat_timeout_s=5.0),
                       clock=lambda: t[0])
        ft.heartbeat(0, 0.1)
        ft.heartbeat(1, 0.1)
        t[0] = 100.0                       # supervisor backoff elapsed
        ft.refresh()
        action, _ = ft.decide()
        assert action is Action.CONTINUE   # a pause is not a death


class _FlakyTrain:
    """A train_fn that raises a scripted failure per attempt, recording the
    (mesh, skip_data_steps) each attempt received."""

    def __init__(self, failures):
        self.failures = list(failures)
        self.calls = []

    def __call__(self, *, mesh=None, skip_data_steps=frozenset()):
        self.calls.append({"mesh": mesh, "skip": set(skip_data_steps)})
        if self.failures:
            raise self.failures.pop(0)
        return {"final_loss": 1.0, "step": 10, "history": []}


class TestSupervisor:
    def _sup(self, fn, **kw):
        sleeps = []
        kw.setdefault("cfg", SupervisorConfig(max_restarts=4,
                                              backoff_base_s=0.1,
                                              backoff_max_s=0.4))
        sup = Supervisor(fn, sleep=sleeps.append, **kw)
        return sup, sleeps

    def test_restart_until_success_with_bounded_backoff(self):
        fn = _FlakyTrain([WorkerKilled("w0", step=3),
                          RestartRequired("w1", step=5),
                          WorkerKilled("w0", step=7)])
        sup, sleeps = self._sup(fn)
        res = sup.run()
        assert res["supervisor"]["attempts"] == 4
        assert [e["kind"] for e in res["supervisor"]["events"]] == \
            ["restart"] * 3
        assert sleeps == [0.1, 0.2, 0.4]            # capped at backoff_max_s

    def test_nan_rollback_widens_skip_window(self):
        fn = _FlakyTrain([NonFiniteLossError(6, float("nan"))])
        sup, _ = self._sup(fn, cfg=SupervisorConfig(nan_skip_window=2))
        res = sup.run()
        assert fn.calls[0]["skip"] == set()
        assert fn.calls[1]["skip"] == {6, 7}
        assert res["supervisor"]["skip_data_steps"] == [6, 7]

    def test_reshape_rebuilds_mesh_from_factory(self):
        target = ((2, 2), ("data", "model"))
        fn = _FlakyTrain([ReshapeRequired("lost", target=target, step=4)])
        built = []

        def factory(t):
            built.append(t)
            return f"mesh{t[0]}"

        sup, _ = self._sup(fn, mesh_factory=factory, mesh="mesh-big")
        res = sup.run()
        assert built == [target]
        assert fn.calls[0]["mesh"] == "mesh-big"
        assert fn.calls[1]["mesh"] == "mesh(2, 2)"
        assert [e["kind"] for e in res["supervisor"]["events"]] == \
            ["elastic_reshape"]

    def test_budget_exhausted_raises(self):
        fn = _FlakyTrain([WorkerKilled("again", step=1)] * 99)
        sup, _ = self._sup(fn)
        with pytest.raises(RestartBudgetExhausted, match="4 restarts"):
            sup.run()

    def test_chaos_and_ft_reset_per_attempt(self):
        eng = ChaosEngine(FaultPlan.parse("kill@1:w1"))
        eng.on_step_start(1)                        # worker 1 suppressed
        t = [0.0]
        ft = FTManager(n_workers=2, cfg=FTConfig(heartbeat_timeout_s=5.0),
                       clock=lambda: t[0])
        ft.heartbeat(0, 0.1)
        t[0] = 50.0
        fn = _FlakyTrain([])
        sup, _ = self._sup(fn, ft=ft, chaos=eng)
        sup.run()
        assert not eng.heartbeat_suppressed(1)      # transient kill rejoined
        assert ft.decide()[0] is Action.CONTINUE    # refresh() reset liveness


class TestChaosDifferential:
    """The robustness acceptance gate: recovery must reproduce the
    uninterrupted run, not merely survive."""

    def test_crash_and_corrupt_recover_bit_identically(self, tmp_path):
        dcfg, tcfg0, ocfg = _cfgs(tmp_path / "base", steps=10)
        base = train(TINY, dcfg, tcfg0, ocfg)

        _, tcfg, _ = _cfgs(tmp_path / "chaos", steps=10)
        chaos = ChaosEngine(FaultPlan.parse("corrupt@4,crash@6"))
        ft = FTManager(n_workers=1)
        sup = Supervisor(
            functools.partial(train, TINY, dcfg, tcfg, ocfg, ft=ft,
                              chaos=chaos),
            ft=ft, chaos=chaos, sleep=lambda s: None)
        res = sup.run()
        # crash at 6 restarted; ckpt 4 was corrupted so the restart fell
        # back further — yet replayed data gives the exact same trajectory
        assert res["supervisor"]["attempts"] >= 2
        assert res["step"] == 10
        assert res["final_loss"] == base["final_loss"]
        assert [m["loss"] for m in res["history"][-3:]] == \
            [m["loss"] for m in base["history"][-3:]]

    def test_sticky_nan_needs_skip_window_to_finish(self, tmp_path):
        dcfg, tcfg, ocfg = _cfgs(tmp_path, steps=8, ckpt_every=3)
        chaos = ChaosEngine(FaultPlan.parse("nan@4:sticky"))
        ft = FTManager(n_workers=1)
        sup = Supervisor(
            functools.partial(train, TINY, dcfg, tcfg, ocfg, ft=ft,
                              chaos=chaos),
            ft=ft, chaos=chaos, sleep=lambda s: None)
        res = sup.run()
        assert res["step"] == 8
        assert np.isfinite(res["final_loss"])
        assert res["supervisor"]["skip_data_steps"] == [4]
        kinds = [e["kind"] for e in res["supervisor"]["events"]]
        assert "nonfinite_rollback" in kinds

    def test_worker_death_triggers_restart_via_ft(self, tmp_path):
        """kill@N suppresses heartbeats; the FT manager (not chaos itself)
        must notice and order a restart — exercising the real decide() path."""
        dcfg, tcfg, ocfg = _cfgs(tmp_path, steps=8, ckpt_every=3)
        chaos = ChaosEngine(FaultPlan.parse("kill@4:w1"))
        t = [0.0]
        ft = FTManager(n_workers=2, cfg=FTConfig(heartbeat_timeout_s=0.5,
                                                 chips_per_worker=1),
                       clock=lambda: t[0])
        orig = ft.heartbeat

        def ticking_heartbeat(w, lat):
            t[0] += 0.3                    # decide() sees w1 time out fast
            orig(w, lat)

        ft.heartbeat = ticking_heartbeat
        sup = Supervisor(
            functools.partial(train, TINY, dcfg, tcfg, ocfg, ft=ft,
                              chaos=chaos),
            ft=ft, chaos=chaos, sleep=lambda s: None)
        res = sup.run()
        assert res["step"] == 8
        assert any(e["kind"] == "restart"
                   for e in res["supervisor"]["events"])


class TestTrainLoopKnobs:
    def test_log_history_bounds_returned_history(self, tmp_path):
        dcfg, tcfg, ocfg = _cfgs(tmp_path, steps=6, ckpt_every=100)
        tcfg = dataclasses.replace(tcfg, log_history=2)
        res = train(TINY, dcfg, tcfg, ocfg)
        assert len(res["history"]) == 2
        assert np.isfinite(res["final_loss"])

    def test_launch_train_cli_supervised_chaos(self, tmp_path, monkeypatch):
        from repro_torch.launch import train as train_cli
        monkeypatch.setattr(train_cli.configs, "arch_names", lambda: ["tiny"])
        monkeypatch.setattr(train_cli.configs, "get_smoke", lambda n: TINY)
        rc = train_cli.main([
            "--arch", "tiny", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path / "c"),
            "--ckpt-every", "3", "--chaos", "crash@3,corrupt@3",
            "--backoff-base", "0", "--device", "cpu"])
        assert rc == 0
