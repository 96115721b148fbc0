"""The port's GPipe pipeline against the stages applied in sequence, on the
CPU over gloo ranks (``repro_torch.dist.spawn``; the rank functions are in
tests/_torch_train_ranks.py).

The reference's pipeline test setup (tests/pipeline_subprocess.py: tanh
MLP stages, D 16, 8 microbatches of 4 rows) at 2 stages on a (2, 2)
("stage", "dp") mesh and 4 stages on (4, 1): the forward within 1e-5 of
the stages in sequence under JAX, and the gradient of mean(y ** 2) for
each stage's params within 1e-4 of the largest |g| of ``jax.grad`` through
the stages in sequence (the reference's own pipelined gradient is not the
comparison: its parity test fails under jax 0.9).  Two decoder blocks of
qwen3's smoke config as two stages, against the same blocks in sequence on
one rank.  ``bubble_fraction`` is the reference's on a grid.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import pipeline as jpipeline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import pipeline as tpipeline  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_train_ranks as ranks  # noqa: E402

D, N_MICRO, MB = 16, 8, 4
MESHES = {2: (2, 2), 4: (4, 1)}


def _setup(n_stages):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((n_stages, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_stages, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((N_MICRO * MB, D)).astype(np.float32)
    return {"w": w, "b": b, "x": x}


def _sequential(params, x):
    h = x
    for i in range(params["w"].shape[0]):
        h = jnp.tanh(h @ params["w"][i] + params["b"][i])
    return h


@pytest.fixture(scope="module")
def pipelined():
    cases = [{**_setup(s), "n_micro": N_MICRO, "mesh": MESHES[s]}
             for s in sorted(MESHES)]
    return spawn.run(ranks.pipelines, 4, args=(cases,), device="cpu",
                     timeout_s=120, deadline_s=600)[0]


@pytest.mark.parametrize("n_stages", sorted(MESHES))
def test_forward_matches_sequential_stages(pipelined, n_stages):
    case = _setup(n_stages)
    got = pipelined[sorted(MESHES).index(n_stages)]["y"]
    want = np.asarray(_sequential({k: jnp.asarray(case[k])
                                   for k in ("w", "b")}, case["x"]))
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < 1e-5


@pytest.mark.parametrize("n_stages", sorted(MESHES))
def test_grads_match_sequential_stages(pipelined, n_stages):
    case = _setup(n_stages)
    params = {k: jnp.asarray(case[k]) for k in ("w", "b")}
    want = jax.grad(lambda p: jnp.mean(_sequential(p, case["x"]) ** 2))(
        params)
    got = pipelined[sorted(MESHES).index(n_stages)]["grads"]
    for k in ("w", "b"):
        ref = np.asarray(want[k])
        err = float(np.max(np.abs(got[k] - ref)) / np.max(np.abs(ref)))
        assert err < 1e-4, (k, err)


def test_qwen_blocks_pipelined_match_sequence():
    """Two decoder blocks of qwen3's smoke config (float32), one a stage,
    4 microbatches: output and each block's gradients against the blocks in
    sequence."""
    cfg = tconfigs.get_smoke("qwen3-1.7b", n_layers=2)
    params = params_to_numpy(TM.init_lm(cfg, seed=0, device="cpu",
                                        dtype=torch.float32))
    x = np.random.default_rng(1).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32)
    outs = spawn.run(ranks.qwen_block_pipeline, 2,
                     args=(cfg, params, x, 4), device="cpu", timeout_s=120,
                     deadline_s=600)
    for out in outs:
        assert float(np.max(np.abs(out["y"] - out["want_y"]))) < 1e-5
        for k, g in out["grads"].items():
            ref = out["want_grads"][k]
            if isinstance(g, dict):
                for kk in g:
                    e = np.max(np.abs(g[kk] - ref[kk])) / np.max(np.abs(
                        ref[kk]))
                    assert e < 1e-4, (k, kk, e)
            else:
                assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-4
    assert sorted(o["stage"] for o in outs) == [0, 1]


def test_bubble_fraction_is_the_reference():
    for s in range(1, 9):
        for m in range(1, 33):
            assert tpipeline.bubble_fraction(s, m) == \
                jpipeline.bubble_fraction(s, m)
    assert tpipeline.bubble_fraction(4, 8) == 3 / 11
