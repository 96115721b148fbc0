"""The captured one-device train step (``train/graphs.py``) on the CPU,
where a ``TrainGraph`` runs its static-buffer step eagerly.

* Three steps through the static batch buffers equal three eager
  ``steps.train_step`` calls bitwise (loss, every metric, every param and
  moment leaf), under remat "full", "dots" and "none" and with two
  microbatches, and match the reference's ``train_step`` from the same
  weights (moved by ``params_from_numpy``) and batches: losses rtol 1e-5,
  params within 0.05 x peak_lr, as tests/test_torch_train.py holds a
  continuation.
* ``train()`` with ``step_graphs`` on gives the history of a run with it
  off, and a batch of another shape raises.
* ``--no-step-graphs`` reaches the loop's config.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.graphs import METRICS, TrainGraph  # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=8)
DATA = dict(global_batch=4, seq_len=16, vocab=128, seed=9)
STEPS = 3
CASES = {"full": ("full", 1), "dots": ("dots", 1), "none": ("none", 1),
         "full_2_microbatches": ("full", 2)}


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_steps_equal_eager_and_the_reference(case):
    policy, micro = CASES[case]
    jcfg = JModelConfig(**TINY, remat_policy=policy)
    tcfg = TModelConfig(**TINY, remat_policy=policy)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.float32)
    ep, eopt = _tree_clone(tp), tadamw.init_opt_state(tp)
    gopt = tadamw.init_opt_state(tp)
    graph = TrainGraph(tp, gopt, cfg=tcfg, opt_cfg=tadamw.OptConfig(**OPT),
                       num_microbatches=micro, device=torch.device("cpu"))
    jopt = jadamw.init_opt_state(jp)
    want_losses, got_losses = [], []
    for s in range(STEPS):
        batch = tpipe.batch_for_model(tcfg, tpipe.DataConfig(**DATA), s,
                                      device="cpu")
        _, _, eager = tsteps.train_step(
            ep, eopt, batch, cfg=tcfg, opt_cfg=tadamw.OptConfig(**OPT),
            num_microbatches=micro)
        static = graph.step(batch)
        assert set(static) == set(METRICS)
        for k in METRICS:
            assert torch.equal(static[k], eager[k]), (s, k)
        got_losses.append(static["loss"].item())
        jp, jopt, jm = jsteps.train_step(
            jp, jopt, jpipe.batch_for_model(jcfg, jpipe.DataConfig(**DATA),
                                            s),
            cfg=jcfg, opt_cfg=jadamw.OptConfig(**OPT),
            num_microbatches=micro)
        want_losses.append(float(jm["loss"]))
    assert graph.captures == 1 and graph.replays == 0
    for a, b in zip(tadamw.leaves({"p": tp, "o": gopt}),
                    tadamw.leaves({"p": ep, "o": eopt})):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jp))
    got = flatten(params_to_numpy(tp))
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=0.05 * OPT["peak_lr"])


def test_train_loop_with_step_graphs_gives_the_eager_history(tmp_path):
    cfg = TModelConfig(**TINY)
    runs = {}
    for on in (True, False):
        tcfg = tloop.TrainConfig(total_steps=4, ckpt_every=2, log_every=100,
                                 ckpt_dir=str(tmp_path / str(on)),
                                 async_ckpt=False, device="cpu",
                                 step_graphs=on)
        runs[on] = tloop.train(cfg, tpipe.DataConfig(**DATA), tcfg,
                               tadamw.OptConfig(**OPT))
    assert [m["loss"] for m in runs[True]["history"]] == \
        [m["loss"] for m in runs[False]["history"]]
    for a, b in zip(tadamw.leaves(runs[True]["params"]),
                    tadamw.leaves(runs[False]["params"])):
        assert torch.equal(a, b)


def test_a_batch_of_another_shape_raises():
    cfg = TModelConfig(**TINY)
    params, opt = tloop.make_train_state(cfg, device="cpu")
    graph = TrainGraph(params, opt, cfg=cfg, opt_cfg=tadamw.OptConfig(),
                       device=torch.device("cpu"))
    dcfg = tpipe.DataConfig(**DATA)
    graph.step(tpipe.batch_for_model(cfg, dcfg, 0, device="cpu"))
    other = tpipe.batch_for_model(
        cfg, dataclasses.replace(dcfg, seq_len=8), 1, device="cpu")
    with pytest.raises(ValueError, match="train graph"):
        graph.step(other)


def test_no_step_graphs_flag_reaches_the_loop(monkeypatch, tmp_path):
    made = []

    def spy(**kwargs):
        made.append(kwargs["step_graphs"])
        return tloop.TrainConfig(**kwargs)
    monkeypatch.setattr(tlaunch, "TrainConfig", spy)
    base = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"]
    assert tlaunch.main(base + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    assert tlaunch.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                                "--no-step-graphs"]) == 0
    # None: on where the device is CUDA and there is no mesh
    assert made == [None, False]
