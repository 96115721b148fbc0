"""The port's sharded training against the JAX package's one-device step,
on the CPU, over gloo ranks (``repro_torch.dist.spawn``; the rank
functions are in tests/_torch_train_ranks.py).

* One sharded step (``steps.sharded_train_step``) on meshes (2, 2), (4, 1),
  (1, 4) and (2, 1) of a 4-rank job (the last leaves two ranks out): the
  reference's parity config (MoE, capacity factor 2.0), a dense config
  with a ragged loss mask (also at 2 microbatches), an MoE config at
  capacity factor 1.25 with global dispatch, and one with 4 dispatch
  groups.  Params and both moments, gathered whole, are held to
  ``repro.launch.steps.train_step`` on one device from the same weights
  (``params_from_numpy``) within a max relative error of 2e-4 a leaf, the
  reference's bound (tests/test_sharding_multidevice.py).  (1, 4) cuts 2
  kv heads over 4 ranks: the divisibility fallback replicates them.  One
  dense case on (2, 2) lays its state out under a ``partition.mesh_rules``
  override that keeps the embed dim whole.
* A checkpoint saved on (2, 2) restores bit for bit on (1, 4), (4, 1), one
  device and through the reference's ``CheckpointManager``.
* The supervised elastic run: 4 ranks on (2, 2), 2 workers x 2 chips,
  worker 1 lost for good at step 4, the ladder ((2, 2), (1, 2)); it
  finishes on (1, 2) within 5e-3 of the uninterrupted run, which is within
  2e-4 of the reference's one-device ``train`` from the same weights.
"""

import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import CheckpointManager as JCheckpoint  # noqa
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten  # noqa
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_train_ranks as ranks  # noqa: E402

REL = 2e-4
BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=128, dtype="float32")
CONFIGS = {
    # tests/sharded_subprocess.py's train_parity config
    "parity": dict(family="moe", n_experts=2, top_k=1, capacity_factor=2.0),
    "dense": dict(family="dense"),
    "moe_1.25": dict(family="moe", n_experts=4, top_k=2,
                     capacity_factor=1.25, moe_groups=0),
    "moe_groups": dict(family="moe", n_experts=4, top_k=2,
                       capacity_factor=1.25, moe_groups=4),
}
MESHES = [(2, 2), (4, 1), (1, 4), (2, 1)]
#: rule overrides a case lays its state out by (``partition.mesh_rules``)
OVERRIDES = {"embed_whole": {"embed": None}}
CASES = [(c, m, 1, None) for c in ("parity", "dense", "moe_1.25")
         for m in MESHES] \
    + [("dense", (2, 2), 2, None), ("dense", (4, 1), 2, None),
       ("moe_groups", (2, 2), 1, None), ("moe_groups", (4, 1), 1, None),
       ("dense", (2, 2), 1, "embed_whole")]
#: the reference parity test's optimizer (warmup 100: the first step's
#: learning rate is 3e-6).  At a rate like 1e-2 the first AdamW step moves
#: every weight by about the rate whatever its gradient's size, so the
#: params would compare the signs of gradients near 0 (the one-device
#: steps of the two packages differ there by up to 2.8e-4); the moments
#: compare the gradients themselves.
OCFG = {}


def _cfgs(name):
    kw = {**BASE, **CONFIGS[name]}
    return JModelConfig(**kw), TModelConfig(**kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _batch():
    rng = np.random.default_rng(0)
    mask = (rng.random((8, 16)) < 0.8).astype(np.float32)
    return {"tokens": rng.integers(0, 128, (8, 16)).astype(np.int32),
            "labels": rng.integers(0, 128, (8, 16)).astype(np.int32),
            "mask": mask}


@pytest.fixture(scope="module")
def parity():
    """(reference results by (config, microbatches), port results by
    case)."""
    batch = _batch()
    refs, cases = {}, []
    for name, mesh, micro, rules in CASES:
        jcfg, tcfg = _cfgs(name)
        b = batch if name == "dense" else {k: v for k, v in batch.items()
                                           if k != "mask"}
        if (name, micro) not in refs:
            params = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
            opt = jadamw.init_opt_state(params)
            p, o, m = jax.jit(functools.partial(
                jsteps.train_step, cfg=jcfg, opt_cfg=jadamw.OptConfig(**OCFG),
                num_microbatches=micro))(
                params, opt, {k: jnp.asarray(v) for k, v in b.items()})
            refs[name, micro] = {
                "start": jax.tree.map(np.asarray, params),
                "params": flatten(jax.tree.map(np.asarray, p)),
                "mu": flatten(jax.tree.map(np.asarray, o["mu"])),
                "nu": flatten(jax.tree.map(np.asarray, o["nu"])),
                "loss": float(m["loss"])}
        cases.append({"cfg": tcfg, "params": refs[name, micro]["start"],
                      "batch": b, "ocfg": tadamw.OptConfig(**OCFG),
                      "micro": micro, "mesh": mesh,
                      "rules": OVERRIDES.get(rules)})
    got = spawn.run(ranks.train_parity, 4, args=(cases,), device="cpu",
                    timeout_s=120, deadline_s=600)
    return refs, got


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c}-{m[0]}x{m[1]}-micro{n}"
                              + (f"-{r}" if r else "")
                              for c, m, n, r in CASES])
def test_sharded_step_is_the_reference_step(parity, case):
    refs, got = parity
    name, mesh, micro, _ = CASES[case]
    ref = refs[name, micro]
    res = got[0][case]
    for part in ("params", "mu", "nu"):
        errs = {k: _rel(res[part][k], ref[part][k]) for k in ref[part]}
        assert sorted(res[part]) == sorted(ref[part])
        assert max(errs.values()) < REL, (part, errs)
    assert abs(res["loss"] - ref["loss"]) <= REL * abs(ref["loss"])
    inside = [g[case] for g in got if g[case] is not None]
    assert len(inside) == mesh[0] * mesh[1]
    assert len({r["loss"] for r in inside}) == 1      # every rank agrees
    d = mesh[0]
    want = "split" if d == 1 or name in ("dense", "moe_groups") \
        else "global"
    assert {r["mode"] for r in inside} == {want}


def test_shards_follow_the_rules_and_the_fallback(parity):
    """On (2, 2) the embed dim is halved over data and heads over model; on
    (1, 4) wq's 4 heads are cut 4 ways but wk's 2 kv heads stay whole (2
    does not divide by 4)."""
    _, got = parity
    at = {(c, m, n): i for i, (c, m, n, r) in enumerate(CASES) if r is None}
    s22 = got[0][at["dense", (2, 2), 1]]["local_shapes"]
    assert s22["blocks/attn/wq"] == (2, 32, 2, 16)
    assert s22["embed"] == (64, 32)             # vocab on model, embed data
    s14 = got[0][at["dense", (1, 4), 1]]["local_shapes"]
    assert s14["blocks/attn/wq"] == (2, 64, 1, 16)
    assert s14["blocks/attn/wk"] == (2, 64, 2, 16)


def test_a_rules_scope_lays_the_state_out(parity):
    """Under ``mesh_rules(mesh, {"embed": None})`` the params stay whole
    along embed on (2, 2) (heads still on model), and the step still is the
    reference's (``test_sharded_step_is_the_reference_step``)."""
    _, got = parity
    shapes = got[0][CASES.index(("dense", (2, 2), 1, "embed_whole"))][
        "local_shapes"]
    assert shapes["blocks/attn/wq"] == (2, 64, 2, 16)
    assert shapes["embed"] == (64, 64)


def test_checkpoint_reshards_bit_for_bit(tmp_path):
    jcfg, tcfg = _cfgs("dense")
    params = jax.tree.map(np.asarray, jnn.unwrap(JM.init_lm(
        jax.random.PRNGKey(3), jcfg)))
    d = str(tmp_path / "ck")
    meshes = [(1, 4), (4, 1)]
    out = spawn.run(ranks.reshard, 4, args=(tcfg, params, d, meshes),
                    device="cpu", timeout_s=120, deadline_s=600)[0]
    want = {f"params/{k}": v for k, v in flatten(params).items()}
    want.update({f"opt/mu/{k}": v for k, v in flatten(params).items()})
    want.update({f"opt/nu/{k}": v * v for k, v in flatten(params).items()})
    assert out["saved_local"]["blocks/attn/wq"] == (2, 32, 2, 16)
    for shape in meshes:
        full = out[str(shape)]["full"]
        for k, v in want.items():
            assert np.array_equal(full[k], v), (shape, k)
        assert int(full["opt/step"]) == 3
    assert out["(1, 4)"]["local"]["blocks/attn/wq"] == (2, 64, 1, 16)
    assert out["(4, 1)"]["local"]["blocks/attn/wq"] == (2, 16, 4, 16)
    # one device, and the reference's reader
    template = {"params": tloop.make_train_state(tcfg, device="cpu")[0]}
    template["opt"] = tadamw.init_opt_state(template["params"])
    one = flatten(CheckpointManager(d).restore(7, template))
    jtemplate = {"params": params, "opt": jadamw.init_opt_state(params)}
    ref = flatten(jax.tree.map(np.asarray,
                               JCheckpoint(d).restore(7, jtemplate)))
    for k, v in want.items():
        assert np.array_equal(one[k].numpy(), v), k
        assert np.array_equal(ref[k], v), k


def test_supervised_elastic_reshape_finishes_on_the_smaller_mesh(tmp_path):
    jcfg, tcfg = _cfgs("dense")
    params = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    start = {"params": params, "opt": jadamw.init_opt_state(params)}
    dirs = {k: str(tmp_path / k) for k in ("ref", "base", "chaos")}
    for d in dirs.values():            # every run starts from these weights
        JCheckpoint(d).save(0, start)
    data = dict(global_batch=8, seq_len=16, vocab=128)
    opt = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=12)
    ref = jloop.train(jcfg, jpipe.DataConfig(**data), jloop.TrainConfig(
        total_steps=12, ckpt_every=4, ckpt_dir=dirs["ref"], log_every=1000),
        jadamw.OptConfig(**opt))
    got = spawn.run(ranks.elastic, 4, args=(
        tcfg, DataConfig(**data), tadamw.OptConfig(**opt), 12, 4,
        dirs["base"], dirs["chaos"], 0.3), device="cpu", timeout_s=120,
        deadline_s=900)
    base = got[0]["base_loss"]
    assert abs(base - ref["final_loss"]) <= REL * abs(ref["final_loss"])
    assert got[0]["base_modes"] == ["split"]
    for r in got[:2]:
        assert r["step"] == 12 and r["final_mesh"] == [1, 2]
        assert not r["outside_mesh"]
        assert abs(r["final_loss"] - base) <= 5e-3 * abs(base)
    for r in got[2:]:                  # left out of (1, 2)
        assert r["outside_mesh"] and r["final_mesh"] == [1, 2]
    events = [r["events"] for r in got]
    assert all(e == events[0] for e in events)
    assert [e["kind"] for e in events[0]] == ["elastic_reshape"]
    assert events[0][0]["target"] == [1, 2]
