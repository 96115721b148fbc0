"""Per-layer rematerialisation (``models/blocks.remat``), the port of the
reference's ``_maybe_remat``, on the CPU:

* the gradients under ``remat_policy`` "full", "dots" and "none" (and remat
  off) are the same within 1e-6 of each leaf's largest |g|, for one smoke
  config per family; for the dense, MoE and SSM ones, one ``train_step``
  under each policy holds the loss (rtol 1e-5) and both moments to the
  reference's ``repro.launch.steps.train_step`` (remat on, "full") from
  the same weights within 2e-4 a leaf (tests/test_torch_train.py holds
  every family's gradients, remat "full" on both sides, to the
  reference's);
* the dry run's ``StepCounter`` sees what remat does: "full" counts
  exactly one more forward of the blocks than "none" (the layers run
  again in the backward), "dots" counts what "none" does (the products
  are saved, nothing with FLOPs runs again), and the peak of live storage
  is lower under "dots" than "none", and no higher under "full";
* serving (no grad) runs the layers as they are.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_model  # noqa
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.optim import adamw as tadamw  # noqa: E402

ARCHS = ["qwen3-1.7b", "dbrx-132b", "mamba2-2.7b", "zamba2-7b",
         "seamless-m4t-large-v2"]
#: the configs whose steps are held to the reference's here
REF_ARCHS = ARCHS[:3]
POLICIES = ("full", "dots", "none")
REL = 2e-4
SAME = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _batch(cfg, seq_len=32):
    b = batch_for_model(cfg, DataConfig(global_batch=2, seq_len=seq_len,
                                        vocab=cfg.vocab, seed=5), 0,
                        device="cpu")
    return b


@functools.lru_cache(maxsize=None)
def _port_runs(arch):
    """(weights, batch, the port's results by policy and with remat off:
    gradients, and for :data:`REF_ARCHS` the loss and moments after one
    ``train_step``).  The weights are the reference's initial ones for
    :data:`REF_ARCHS` (numpy), else the port's own."""
    tcfg = tconfigs.get_smoke(arch)
    batch = _batch(tcfg)
    if arch in REF_ARCHS:
        jp = jax.tree.map(np.asarray, jnn.unwrap(JM.init_lm(
            jax.random.PRNGKey(0), jconfigs.get_smoke(arch))))
    else:
        jp = params_to_numpy(TM.init_lm(tcfg, seed=0, device="cpu",
                                        dtype=torch.float32))
    port = {}
    for pol in POLICIES + ("off",):
        cfg = dataclasses.replace(tcfg, remat=pol != "off",
                                  remat_policy="full" if pol == "off"
                                  else pol)
        params = params_from_numpy(jp, cfg, device="cpu",
                                   dtype=torch.float32)
        _, grads = tsteps.loss_and_grads(params, batch, cfg=cfg)
        port[pol] = {"grads": {k: v.numpy() for k, v in
                               flatten(grads).items()}}
        if arch in REF_ARCHS and pol != "off":
            opt = tadamw.init_opt_state(params)
            _, opt, m = tsteps.train_step(params, opt, batch, cfg=cfg,
                                          opt_cfg=tadamw.OptConfig())
            port[pol].update(
                loss=float(m["loss"]),
                mu={k: v.numpy() for k, v in flatten(opt["mu"]).items()},
                nu={k: v.numpy() for k, v in flatten(opt["nu"]).items()})
    return jp, batch, port


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    """The reference's ``train_step`` (remat "full") from the same weights
    and batch: its loss and moments."""
    jcfg = jconfigs.get_smoke(arch)
    assert jcfg.remat and jcfg.remat_policy == "full"
    jp, batch, _ = _port_runs(arch)
    _, jo, jm = jax.jit(functools.partial(
        jsteps.train_step, cfg=jcfg, opt_cfg=jadamw.OptConfig()))(
        jp, jadamw.init_opt_state(jp),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return {"loss": float(jm["loss"]),
            "mu": flatten(jax.tree.map(np.asarray, jo["mu"])),
            "nu": flatten(jax.tree.map(np.asarray, jo["nu"]))}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_are_the_same_under_every_policy(arch):
    port = _port_runs(arch)[2]
    want = port["none"]["grads"]
    for pol in ("full", "dots", "off"):
        got = port[pol]["grads"]
        assert sorted(got) == sorted(want)
        errs = {k: _rel(got[k], want[k]) for k in want}
        assert max(errs.values()) < SAME, (pol, errs)


@pytest.mark.parametrize("arch", REF_ARCHS)
@pytest.mark.parametrize("pol", POLICIES)
def test_each_policy_steps_as_the_reference(arch, pol):
    ref, got = _ref_step(arch), _port_runs(arch)[2][pol]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for part in ("mu", "nu"):
        assert sorted(got[part]) == sorted(ref[part])
        errs = {k: _rel(got[part][k], ref[part][k]) for k in ref[part]}
        assert max(errs.values()) < REL, (part, errs)


def _blocks_forward_flops(params, batch, cfg) -> int:
    """FLOPs of one forward of the blocks alone, without grad."""
    x = TM.embed_inputs(params, batch, cfg)

    def run():
        with torch.no_grad():
            if cfg.family == "ssm":
                blocks.mamba_stack(params["blocks"], x, cfg)
            else:
                h = x
                for lp in blocks.layer_views(params["blocks"]):
                    h = blocks.decoder_block(lp, h, cfg)[0]
    return dryrun.count(run, (params, x))["flops"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b",
                                  "mamba2-2.7b"])
def test_counts_show_what_each_policy_recomputes_and_keeps(arch):
    base = tconfigs.get_smoke(arch)
    params = TM.init_lm(base, seed=0, device="cpu", dtype=torch.float32)
    batch = _batch(base, seq_len=64)
    counted = {}
    for pol in POLICIES:
        cfg = dataclasses.replace(base, remat_policy=pol)
        counted[pol] = dryrun.count(lambda: tsteps.loss_and_grads(
            params, batch, cfg=cfg), (params, batch))
    forward = _blocks_forward_flops(params, batch, base)
    assert forward > 0
    assert counted["full"]["flops"] - counted["none"]["flops"] == forward
    assert counted["dots"]["flops"] == counted["none"]["flops"]
    assert counted["full"]["peak_bytes"] <= counted["dots"]["peak_bytes"] \
        < counted["none"]["peak_bytes"]


def test_remat_wraps_only_under_grad():
    cfg = tconfigs.get_smoke("qwen3-1.7b")
    calls = []

    def layer(x):
        calls.append(torch.is_grad_enabled())
        return torch.sin(x)

    wrapped = blocks.remat(layer, cfg)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        wrapped(x)
    assert calls == [False]                  # serving: run once, as it is
    wrapped(x).sum().backward()
    assert calls == [False, True, True]      # training: run again backward
    assert blocks.remat(layer, dataclasses.replace(
        cfg, remat_policy="none")) is layer
    assert blocks.remat(layer, dataclasses.replace(cfg, remat=False)) \
        is layer
    with pytest.raises(ValueError):
        blocks.remat(layer, dataclasses.replace(cfg, remat_policy="some"))
