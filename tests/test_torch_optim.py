"""The port's AdamW against the JAX package's on random trees: the
schedule, global-norm clipping and the update (clip, step + 1, bias
correction, decoupled weight decay), to rtol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.models.model import map_params  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

RTOL = 1e-6
KW = dict(peak_lr=3e-3, warmup_steps=3, decay_steps=20, weight_decay=0.1,
          clip_norm=1.0)


def _tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
                  "b": rng.standard_normal((5,)).astype(np.float32) * scale},
            "z": rng.standard_normal((3, 2, 4)).astype(np.float32) * scale}


def _torch(tree):
    return map_params(lambda _, a: torch.from_numpy(a.copy()), tree)


def _assert_close(got, want):
    """rtol 1e-6 elementwise, with an atol of 1e-6 of the leaf's largest
    magnitude: where ``b1 * m + (1 - b1) * g`` cancels, one rounding of
    the clip scale (the two packages sum the squares in other orders)
    is a larger share of the small result."""
    jleaves = jax.tree.leaves(want)          # sorted keys, as adamw.leaves
    tleaves = tadamw.leaves(got)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 11, 19, 20, 35])
def test_lr_at_is_the_reference_schedule(step):
    want = jadamw.lr_at(jnp.asarray(step, jnp.int32),
                        jadamw.OptConfig(**KW))
    got = tadamw.lr_at(torch.tensor(step, dtype=torch.int32),
                       tadamw.OptConfig(**KW))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_by_global_norm_is_the_reference(scale):
    tree = _tree(np.random.default_rng(1), scale)
    want, wnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), 1.0)
    got, gnorm = tadamw.clip_by_global_norm(_torch(tree), 1.0)
    np.testing.assert_allclose(gnorm.item(), float(wnorm), rtol=RTOL)
    _assert_close(got, want)


@pytest.mark.parametrize("scale", [0.05, 5.0])
def test_adamw_update_is_the_reference_over_steps(scale):
    """Five updates from the same state: params, moments and step, with the
    lr and grad norm each step; the gradients are clipped at 5.0."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init_opt_state(jp)
    tp = _torch(params)
    tstate = tadamw.init_opt_state(tp)
    for _ in range(5):
        grads = _tree(rng, scale)
        jp, jstate, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jp,
            jadamw.OptConfig(**KW))
        tp, tstate, tm = tadamw.adamw_update(
            _torch(grads), tstate, tp, tadamw.OptConfig(**KW))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=RTOL)
        assert tstate["step"].dtype == torch.int32
        assert tstate["step"].item() == int(jstate["step"])
    # params move by lr-sized steps: hold them to rtol on their values
    _assert_close(tp, jp)
    _assert_close(tstate["mu"], jstate["mu"])
    _assert_close(tstate["nu"], jstate["nu"])


def test_zero_gradient_still_decays_the_weights():
    """A leaf the loss never reads gets zero gradients, and AdamW still
    applies the decoupled weight decay to it, as the reference does."""
    p = {"w": torch.ones(4)}
    state = tadamw.init_opt_state(p)
    cfg = tadamw.OptConfig(peak_lr=1e-2, warmup_steps=1)
    tadamw.adamw_update({"w": torch.zeros(4)}, state, p, cfg)
    want = 1.0 - tadamw.lr_at(torch.tensor(1), cfg).item() * 0.1
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-6)
