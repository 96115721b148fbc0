"""The port's training step and loop against the JAX package's, on the
CPU: ``loss_fn`` and its gradients for the TINY dense config and one smoke
config per family, from the same weights (moved by ``params_from_numpy``)
and the same batch; an unread leaf's zero gradient and weight decay; the
microbatch and loss-decrease contracts of tests/test_steps_and_loop.py; a
bit-exact restart; and a run that the reference starts and the port
resumes from the reference's checkpoint.

Tolerances: loss rtol 1e-5; each gradient leaf within 1e-4 of that leaf's
largest |g| (the two packages sum in other orders; measured at most
1.8e-5, on zamba2); a continuation's losses rtol 1e-5 and its params
within 0.05 x peak_lr (a twentieth of one step's largest move)."""

import collections
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tfa  # noqa: E402
from repro_torch.kernels.ssd import ops as tsk_ops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
JTINY, TTINY = JModelConfig(**TINY), TModelConfig(**TINY)
ARCHS = ["qwen3-1.7b", "mamba2-2.7b", "zamba2-7b", "dbrx-132b",
         "seamless-m4t-large-v2", "llava-next-34b", "h2o-danube-1.8b"]
GRAD_TOL = 1e-4


def _configs(arch):
    if arch == "tiny":
        return JTINY, TTINY
    return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)


def _setup(arch, seq_len=32):
    """(jcfg, tcfg, reference params, port params, reference batch, port
    batch): the same weights and the same data step 0."""
    jcfg, tcfg = _configs(arch)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.float32)
    kw = dict(global_batch=2, seq_len=seq_len, vocab=jcfg.vocab, seed=5)
    jb = jpipe.batch_for_model(jcfg, jpipe.DataConfig(**kw), 0)
    tb = tpipe.batch_for_model(tcfg, tpipe.DataConfig(**kw), 0,
                               device="cpu")
    return jcfg, tcfg, jp, tp, jb, tb


@pytest.mark.parametrize("arch", ["tiny"] + ARCHS)
def test_loss_and_grads_are_the_reference(arch):
    """Every reference leaf has a port gradient at the same path and shape,
    within GRAD_TOL of the leaf's largest |g|; aux losses included (dbrx)."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(
        arch, seq_len=64 if arch == "h2o-danube-1.8b" else 32)
    (jtotal, jmet), jg = jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg), has_aux=True)(jp, jb)
    tmet, tg = tsteps.loss_and_grads(tp, tb, cfg=tcfg)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    jflat = flatten(jax.tree.map(np.asarray, jg))
    tflat = flatten(tg)
    assert jflat.keys() == tflat.keys()
    for path, want in jflat.items():
        got = tflat[path].numpy()
        assert got.shape == want.shape and got.dtype == np.float32, path
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * scale or err == scale == 0, \
            (path, err / max(scale, 1e-30))


def test_unread_embed_gets_zero_grad_and_weight_decay():
    """An embeddings-mode batch never reads llava's ``embed``: its gradient
    is zeros, as ``jax.grad`` gives, and one AdamW step still decays it
    exactly as the reference's step does."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("llava-next-34b")
    assert "embeds" in tb and "tokens" not in tb
    _, grads = tsteps.loss_and_grads(tp, tb, cfg=tcfg)
    assert not grads["embed"].any()
    ocfg = dict(peak_lr=1e-2, warmup_steps=1)
    jp2, _, _ = jsteps.train_step(jp, jadamw.init_opt_state(jp), jb,
                                  cfg=jcfg, opt_cfg=jadamw.OptConfig(**ocfg))
    before = tp["embed"].clone()
    tsteps.train_step(tp, tadamw.init_opt_state(tp), tb, cfg=tcfg,
                      opt_cfg=tadamw.OptConfig(**ocfg))
    np.testing.assert_allclose(tp["embed"].numpy(), np.asarray(jp2["embed"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tp["embed"].numpy(),
                               (before * (1 - 1e-2 * 0.1)).numpy(),
                               rtol=1e-6)


def _batch(b=4, s=16, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
                rng.integers(0, vocab, (b, s)).astype(np.int32)),
            "labels": torch.from_numpy(
                rng.integers(0, vocab, (b, s)).astype(np.int32))}


class TestTrainStep:
    def test_microbatch_equivalence(self):
        """num_microbatches=1 vs 4 must produce (near-)identical updates."""
        batch = _batch(8)
        out = []
        for n in (1, 4):
            params, opt = tloop.make_train_state(TTINY, device="cpu")
            out.append(tsteps.train_step(params, opt, batch, cfg=TTINY,
                                         opt_cfg=tadamw.OptConfig(),
                                         num_microbatches=n))
        (p1, _, m1), (p4, _, m4) = out
        assert m1["loss"].item() == pytest.approx(m4["loss"].item(),
                                                  rel=1e-5)
        for a, b in zip(tadamw.leaves(p1), tadamw.leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5)

    def test_loss_decreases_over_steps(self):
        params, opt = tloop.make_train_state(TTINY, device="cpu")
        batch = _batch(8)                       # overfit one batch
        losses = []
        for _ in range(20):
            params, opt, m = tsteps.train_step(
                params, opt, batch, cfg=TTINY,
                opt_cfg=tadamw.OptConfig(peak_lr=1e-2, warmup_steps=1))
            losses.append(m["loss"].item())
        assert losses[-1] < losses[0] - 0.5


class TestTrainLoop:
    def test_restart_bit_exact(self, tmp_path):
        """Interrupted + resumed training must equal uninterrupted training
        (checkpoint + stateless data pipeline => bit-exact restart)."""
        dcfg = tpipe.DataConfig(global_batch=4, seq_len=16, vocab=128, seed=9)
        ocfg = tadamw.OptConfig(peak_lr=1e-3, warmup_steps=2)
        t_all = tloop.TrainConfig(total_steps=8, ckpt_every=100,
                                  log_every=100, ckpt_dir=str(tmp_path / "a"),
                                  async_ckpt=False, device="cpu")
        run_a = tloop.train(TTINY, dcfg, t_all, ocfg)
        t_half = dataclasses.replace(t_all, total_steps=4, ckpt_every=4,
                                     ckpt_dir=str(tmp_path / "b"))
        tloop.train(TTINY, dcfg, t_half, ocfg)
        t_resume = dataclasses.replace(t_half, total_steps=8)
        run_b = tloop.train(TTINY, dcfg, t_resume, ocfg)   # resumes at 4
        assert len(run_b["history"]) == 4
        np.testing.assert_allclose(run_a["final_loss"], run_b["final_loss"],
                                   rtol=1e-6)
        for a, b in zip(tadamw.leaves(run_a["params"]),
                        tadamw.leaves(run_b["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)

    def test_port_resumes_the_reference_run(self, tmp_path):
        """The reference trains TINY 4 steps and checkpoints; the port
        resumes a copy of that directory to step 8 while the reference
        resumes its own: the same losses and params at every step."""
        kw = dict(global_batch=4, seq_len=16, vocab=128, seed=9)
        ocfg = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=8)
        jt = jloop.TrainConfig(total_steps=4, ckpt_every=4, log_every=100,
                               ckpt_dir=str(tmp_path / "ref"),
                               async_ckpt=False)
        jloop.train(JTINY, jpipe.DataConfig(**kw), jt,
                    jadamw.OptConfig(**ocfg))
        shutil.copytree(tmp_path / "ref", tmp_path / "port")
        jres = jloop.train(JTINY, jpipe.DataConfig(**kw),
                           dataclasses.replace(jt, total_steps=8),
                           jadamw.OptConfig(**ocfg))
        tres = tloop.train(
            TTINY, tpipe.DataConfig(**kw),
            tloop.TrainConfig(total_steps=8, ckpt_every=4, log_every=100,
                              ckpt_dir=str(tmp_path / "port"),
                              async_ckpt=False, device="cpu"),
            tadamw.OptConfig(**ocfg))
        jl = [m["loss"] for m in jres["history"]]
        tl = [m["loss"] for m in tres["history"]]
        assert len(jl) == len(tl) == 4
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        want = flatten(jax.tree.map(np.asarray, jres["params"]))
        got = flatten(params_to_numpy(tres["params"]))
        assert want.keys() == got.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=0.05 * ocfg["peak_lr"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "zamba2-7b"])
def test_use_pallas_picks_the_kernels_and_training_leaves_it_off(
        arch, monkeypatch):
    """``cfg.use_pallas`` routes the model through the kernel wrappers
    (flash at prefill, the SSD), as the serving engines set it; without it
    the model runs their plain versions (the same values on the CPU), and
    the train step turns it off whatever the caller's config says."""
    calls = collections.Counter()

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(tfa, "flash_attention",
                        spy("flash", tfa.flash_attention))
    monkeypatch.setattr(tsk_ops, "ssd_chunked_kernel",
                        spy("ssd", tsk_ops.ssd_chunked_kernel))
    cfg = tconfigs.get_smoke(arch)
    params = TM.init_lm(cfg, seed=0, device="cpu")
    batch = tpipe.batch_for_model(
        cfg, tpipe.DataConfig(global_batch=2, seq_len=32, vocab=cfg.vocab),
        0, device="cpu")
    with torch.no_grad():
        plain, _ = TM.forward(params, batch, cfg)
        assert not calls
        kern, _ = TM.forward(params, batch,
                             dataclasses.replace(cfg, use_pallas=True))
    want = {"flash": cfg.family != "ssm",
            "ssd": cfg.family in ("ssm", "hybrid")}
    assert {k: calls[k] > 0 for k in want} == want
    assert torch.equal(kern, plain)
    calls.clear()
    tsteps.loss_and_grads(params, batch,
                          cfg=dataclasses.replace(cfg, use_pallas=True))
    assert not calls


def test_engines_serve_on_the_kernels():
    """Both engines set ``use_pallas`` on their copy of the config, as the
    reference's serve launcher does; the caller's config is untouched."""
    from repro_torch.serve.engine import ContinuousEngine, Engine
    params = TM.init_lm(TTINY, seed=0, device="cpu")
    for engine in (Engine(params, TTINY), ContinuousEngine(params, TTINY)):
        assert engine.cfg.use_pallas
        assert engine.cfg == dataclasses.replace(TTINY, use_pallas=True)
    assert not TTINY.use_pallas
