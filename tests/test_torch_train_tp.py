"""Training sharded along ``"model"`` (``steps.sharded_train_step`` under
``steps.model_split``), on the CPU over gloo ranks
(``repro_torch.dist.spawn``; the rank functions are in
tests/_torch_train_tp_ranks.py):

* the vocab-parallel cross-entropy (``M.token_losses`` under a training
  scope that cuts the vocab) over 2 and 4 ranks equals the one-device
  ``_xent``, with and without ``logits_microbatch`` and a loss mask: token
  losses within 1e-6, the gradient's column blocks within 1e-6;
* qwen3's, dbrx's and llava's smoke configs (dense with qk-norm and 2 kv
  heads, MoE with 4 experts, VLM on embeddings), one step on (1, 2) and
  (1, 4) counted by the dry run's ``StepCounter``: no all-gather along
  ``"model"`` at all (no leaf that ``"model"`` cuts is gathered whole,
  and the seams are all-reduces), all-reduces along it, each rank's FLOPs
  at most the one-device step's over the ranks plus what stays
  replicated, and the first moment, gathered whole, within 2e-4 a leaf of
  the one-device step's (``steps.train_step``) from the same weights,
  which tests/test_torch_train.py holds to the reference;
* which seams :func:`~repro_torch.launch.steps.model_split` cuts, and
  where it falls back: kv heads fewer than the ranks read their query
  heads' kv head; heads that do not divide the ranks gather the attention
  whole; the ssm family splits nothing.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_model  # noqa
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_train_tp_ranks as ranks  # noqa: E402

REL = 2e-4
ARCHS = ("qwen3-1.7b", "dbrx-132b", "llava-next-34b")
MESHES = ((1, 2), (1, 4))
#: (mask, logits_microbatch, mesh) of the cross-entropy cases
XENT = [(m, mb, mesh) for mesh in MESHES for m in (False, True)
        for mb in (0, 4)]


def _cfg(arch):
    return configs.get_smoke(arch)


def _batch(cfg):
    b = batch_for_model(cfg, DataConfig(global_batch=4, seq_len=16,
                                        vocab=cfg.vocab, seed=3), 0,
                        device="cpu")
    return {k: v.numpy() for k, v in b.items()}


# ------------------------------------------------------------ cross-entropy
@pytest.fixture(scope="module")
def xent_runs():
    rng = np.random.default_rng(7)
    v = 64
    logits = (3 * rng.standard_normal((2, 8, v))).astype(np.float32)
    labels = rng.integers(0, v, (2, 8)).astype(np.int64)
    mask = (rng.random((2, 8)) < 0.7).astype(np.float32)
    cases = [{"logits": logits, "labels": labels,
              "mask": mask if m else None, "mesh": mesh,
              "cfg": dataclasses.replace(_cfg("qwen3-1.7b"),
                                         logits_microbatch=mb)}
             for m, mb, mesh in XENT]
    got = spawn.run(ranks.xent, 4, args=(cases,), device="cpu",
                    timeout_s=60, deadline_s=180)
    return cases, got


@pytest.mark.parametrize("i", range(len(XENT)),
                         ids=[f"mask{int(m)}-micro{mb}-{n[1]}ranks"
                              for m, mb, n in XENT])
def test_vocab_parallel_xent_is_the_one_device_xent(xent_runs, i):
    cases, got = xent_runs
    case = cases[i]
    logits = torch.from_numpy(case["logits"]).requires_grad_()
    tl = M.token_losses(logits, torch.from_numpy(case["labels"]),
                        case["cfg"])
    mask = case["mask"]
    loss = tl.mean() if mask is None else \
        (tl * torch.from_numpy(mask)).sum() / float(mask.sum())
    loss.backward()
    loss = float(loss.detach())
    n = case["mesh"][1]
    inside = [g[i] for g in got if g[i] is not None]
    assert len(inside) == n
    grad = np.concatenate([r["grad"] for r in inside], axis=-1)
    for r in inside:
        np.testing.assert_allclose(r["token_losses"], tl.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert abs(r["loss"] - loss) <= 1e-6 * abs(loss)
    np.testing.assert_allclose(grad, logits.grad.numpy(), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------- sharded steps
@pytest.fixture(scope="module")
def stepped():
    """(one-device results by arch, the ranks' results by case)."""
    one, cases = {}, []
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = M.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        batch = _batch(cfg)
        p = M.map_params(lambda _, t: t.clone(), params)
        o = adamw.init_opt_state(p)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        counted = dryrun.count(lambda: steps.train_step(
            p, o, tb, cfg=cfg, opt_cfg=adamw.OptConfig()), (p, o, tb))
        one[arch] = {"mu": {k: v.numpy() for k, v in
                            steps._items(o["mu"])},
                     "flops": counted["flops"]}
        for mesh in MESHES:
            cases.append({"arch": arch, "cfg": cfg, "mesh": mesh,
                          "params": params_to_numpy(params),
                          "batch": batch})
    got = spawn.run(ranks.counted_steps, 4, args=(cases,), device="cpu",
                    timeout_s=120, deadline_s=400)
    return one, cases, got


CASE_IDS = [f"{a}-{m[0]}x{m[1]}" for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("i", range(len(ARCHS) * len(MESHES)), ids=CASE_IDS)
def test_no_leaf_is_gathered_along_model(stepped, i):
    one, cases, got = stepped
    case = cases[i]
    n = case["mesh"][1]
    inside = [g[i] for g in got if g[i] is not None]
    assert len(inside) == n
    for r in inside:
        by_axis = r["counts"]["collective_bytes_by_axis"]
        assert by_axis["model"]["all-gather"] == 0, by_axis
        assert by_axis["model"]["all-reduce"] > 0
        assert r["whole"] == []
        assert r["counts"]["flops"] < one[case["arch"]]["flops"] \
            * (0.62 if n == 2 else 0.36)
    assert len({r["loss"] for r in inside}) == 1


@pytest.mark.parametrize("i", range(len(ARCHS) * len(MESHES)), ids=CASE_IDS)
def test_sharded_step_is_the_one_device_step(stepped, i):
    one, cases, got = stepped
    want = {"/".join(k): v for k, v in one[cases[i]["arch"]]["mu"].items()}
    mu = got[0][i]["mu"]
    assert sorted(mu) == sorted(want)
    errs = {k: float(np.max(np.abs(mu[k] - want[k]))
                     / (np.max(np.abs(want[k])) + 1e-12)) for k in want}
    assert max(errs.values()) < REL, errs


def test_the_seams_each_config_cuts(stepped):
    _, cases, got = stepped
    cut = {(c["arch"], c["mesh"]): got[0][i]["cut"]
           for i, c in enumerate(cases)}
    # dbrx smoke: 4 experts cut over 2 and 4 ranks (expert-parallel)
    assert cut["dbrx-132b", (1, 4)] == ["attn", "experts", "router",
                                        "vocab"]
    for arch in ("qwen3-1.7b", "llava-next-34b"):
        assert cut[arch, (1, 4)] == ["attn", "mlp", "vocab"]
    local = got[0][next(i for i, c in enumerate(cases)
                        if c["arch"] == "qwen3-1.7b" and c["mesh"] == (1, 4))]
    # 4 heads over 4 ranks, 2 kv heads shared: one of each a rank
    assert (local["local_cfg"]["n_heads"],
            local["local_cfg"]["n_kv_heads"]) == (1, 1)


class _FakeMesh:
    """A mesh shape with coordinates, no process groups: enough for the
    shardings and :func:`steps.model_split`."""

    def __init__(self, shape):
        self.shape = dict(zip(ranks.AXES, shape))

    def coord(self, axis):
        return self.shape[axis] - 1


@pytest.mark.parametrize("kw,cut,whole", [
    # kv heads 2 over 4 ranks: each rank reads its query heads' kv head
    (dict(), {"attn", "mlp", "vocab"}, set()),
    # 6 heads over 4 ranks do not divide: nothing of the attention is
    # cut, and its compute is replicated
    (dict(n_heads=6, n_kv_heads=3), {"mlp", "vocab"}, set()),
    # 12 heads cut 4 ways, but 3 kv heads neither cut nor map a rank's
    # heads to one kv head: wq and wo are gathered whole
    (dict(n_heads=12, n_kv_heads=3), {"mlp", "vocab"},
     {"blocks/attn/wq", "blocks/attn/wo"}),
])
def test_model_split_falls_back_where_a_dim_does_not_divide(kw, cut, whole):
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), **kw)
    mesh = _FakeMesh((1, 4))
    split = steps.model_split(cfg, mesh, steps.param_shardings(cfg, mesh))
    assert set(split.cut) == cut
    assert {"/".join(p) for p in split.whole} == whole
    if "attn" in cut:
        assert split.kv == 1 and split.cfg.n_kv_heads == 1


def test_families_the_seams_do_not_cover_split_nothing():
    mesh = _FakeMesh((1, 4))
    for arch in ("mamba2-2.7b", "zamba2-7b", "seamless-m4t-large-v2"):
        cfg = _cfg(arch)
        assert steps.model_split(
            cfg, mesh, steps.param_shardings(cfg, mesh)) is None
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), padded_heads=8)
    assert steps.model_split(cfg, mesh,
                             steps.param_shardings(cfg, mesh)) is None
