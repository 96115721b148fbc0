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
* mamba2's and zamba2's smoke configs (ssm, and hybrid with its shared
  attention and MLP) on (1, 2) and (2, 2), mamba2 at ``d_model`` 96 (6
  SSM heads, 3 a rank) on (1, 2) and at ``ssm_state`` 15 on (1, 4)
  (``in_proj`` and the conv whole), held the same ways, and their first
  moments also within 2e-4 a leaf of the reference's own one-device
  ``repro.launch.steps.train_step`` on the same numpy weights and batch;
* seamless's smoke config (enc-dec: the encoder's, the decoder's self-
  and cross-attention's heads, both MLPs and the decoder's vocab cut) on
  (1, 2), (1, 4) (2 kv heads shared by 4 ranks: each reads its query
  head's) and (2, 2), held the same ways, its first moment also within
  2e-4 a leaf of the reference's one-device ``train_step``;
* which seams :func:`~repro_torch.launch.steps.model_split` cuts, and
  where it falls back: kv heads fewer than the ranks read their query
  heads' kv head; heads that do not divide the ranks gather the attention
  (an enc-dec's three attention subtrees) whole; padded heads split
  nothing.
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
#: (arch, smoke overrides, mesh) of the SSM mixer's cases: d_model 96 gives
#: 6 SSM heads, an odd 3 a rank at 2 ranks; ssm_state 15 leaves in_proj's
#: 550 columns and the conv's 286 channels whole at 4 ranks (sliced at
#: use, their gradients summed) while its 8 heads are cut
SSM_CASES = [(a, {}, m) for a in ("mamba2-2.7b", "zamba2-7b")
             for m in ((1, 2), (2, 2))] + \
    [("mamba2-2.7b", {"d_model": 96}, (1, 2)),
     ("mamba2-2.7b", {"ssm_state": 15}, (1, 4))]
#: seamless's smoke config (4 heads, 2 kv heads, vocab 512) on every mesh
ENCDEC_CASES = [("seamless-m4t-large-v2", {}, m)
                for m in ((1, 2), (1, 4), (2, 2))]
#: (mask, logits_microbatch, mesh) of the cross-entropy cases
XENT = [(m, mb, mesh) for mesh in MESHES for m in (False, True)
        for mb in (0, 4)]


def _cfg(arch, **over):
    return configs.get_smoke(arch, **over)


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
#: every case of the sharded steps: (arch, smoke overrides, mesh)
STEP_CASES = [(a, {}, m) for a in ARCHS for m in MESHES] + SSM_CASES \
    + ENCDEC_CASES
CASE_IDS = [f"{a}{''.join(f'-{k}{v}' for k, v in o.items())}-{m[0]}x{m[1]}"
            for a, o, m in STEP_CASES]


@pytest.fixture(scope="module")
def stepped():
    """(one-device results by case, the cases, the ranks' results by
    case)."""
    one, cases = [], []
    for arch, over, mesh in STEP_CASES:
        cfg = _cfg(arch, **over)
        params = M.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        batch = _batch(cfg)
        p = M.map_params(lambda _, t: t.clone(), params)
        o = adamw.init_opt_state(p)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        counted = dryrun.count(lambda: steps.train_step(
            p, o, tb, cfg=cfg, opt_cfg=adamw.OptConfig()), (p, o, tb))
        one.append({"mu": {k: v.numpy() for k, v in
                           steps._items(o["mu"])},
                    "flops": counted["flops"]})
        cases.append({"arch": arch, "cfg": cfg, "mesh": mesh,
                      "params": params_to_numpy(params), "batch": batch})
    got = spawn.run(ranks.counted_steps, 4, args=(cases,), device="cpu",
                    timeout_s=120, deadline_s=400)
    return one, cases, got


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=CASE_IDS)
def test_no_leaf_is_gathered_along_model(stepped, i):
    one, cases, got = stepped
    case = cases[i]
    n = case["mesh"][1]
    inside = [g[i] for g in got if g[i] is not None]
    assert len(inside) == case["mesh"][0] * n
    for r in inside:
        by_axis = r["counts"]["collective_bytes_by_axis"]
        assert by_axis["model"]["all-gather"] == 0, by_axis
        assert by_axis["model"]["all-reduce"] > 0
        assert r["whole"] == []
        assert r["counts"]["flops"] < one[i]["flops"] \
            * (0.62 if n == 2 else 0.36) / case["mesh"][0]
    assert len({r["loss"] for r in inside}) == 1


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=CASE_IDS)
def test_sharded_step_is_the_one_device_step(stepped, i):
    one, _, got = stepped
    _assert_mu(got[0][i]["mu"],
               {"/".join(k): v for k, v in one[i]["mu"].items()})


#: the SSM cases held to the reference too: each config's first, on (1, 2)
REFERENCE_CASES = [i for i, (_, _, m) in enumerate(STEP_CASES)
                   if STEP_CASES[i] in SSM_CASES and m == (1, 2)]


def _reference_mu(case) -> dict:
    """The first moment after the JAX package's one-device ``train_step``
    from the case's numpy weights and batch, by leaf path; run without
    remat (the same math; its remat's compile takes ~19 s a config on the
    CPU)."""
    jax = pytest.importorskip("jax")
    from repro.launch import steps as jsteps
    from repro.models.config import ModelConfig as JConfig
    from repro.optim import adamw as jadamw
    jp = jax.tree.map(jax.numpy.asarray, case["params"])
    _, opt, _ = jsteps.train_step(
        jp, jadamw.init_opt_state(jp),
        {k: jax.numpy.asarray(v) for k, v in case["batch"].items()},
        cfg=JConfig(**{**dataclasses.asdict(case["cfg"]), "remat": False}),
        opt_cfg=jadamw.OptConfig())
    return {"/".join(k): np.asarray(v) for k, v in steps._items(opt["mu"])}


def _assert_mu(mu: dict, want: dict) -> None:
    assert sorted(mu) == sorted(want)
    errs = {k: float(np.max(np.abs(mu[k] - want[k]))
                     / (np.max(np.abs(want[k])) + 1e-12)) for k in want}
    assert max(errs.values()) < REL, errs


@pytest.mark.parametrize("i", REFERENCE_CASES,
                         ids=[CASE_IDS[i] for i in REFERENCE_CASES])
def test_ssm_sharded_step_is_the_reference_step(stepped, i):
    """mamba2's, zamba2's and the odd override's first moment after one
    sharded step on (1, 2), gathered whole, is the JAX package's
    one-device ``train_step``'s from the same numpy weights and batch,
    within 2e-4 of each leaf's largest entry (the other meshes are held to
    the port's one-device step, which is the same for every mesh)."""
    _, cases, got = stepped
    _assert_mu(got[0][i]["mu"], _reference_mu(cases[i]))


#: the enc-dec cases, every mesh held to the reference
ENCDEC_INDICES = [STEP_CASES.index(c) for c in ENCDEC_CASES]


@pytest.fixture(scope="module")
def encdec_reference(stepped):
    """The reference's first moment of the enc-dec cases (one config, one
    init and one batch for every mesh: one run)."""
    return _reference_mu(stepped[1][ENCDEC_INDICES[0]])


@pytest.mark.parametrize("i", ENCDEC_INDICES,
                         ids=[CASE_IDS[i] for i in ENCDEC_INDICES])
def test_encdec_sharded_step_is_the_reference_step(stepped,
                                                   encdec_reference, i):
    """seamless's first moment after one sharded step on (1, 2), (1, 4)
    and (2, 2), its encoder, decoder and cross-attention split by heads,
    gathered whole, is the JAX package's one-device ``train_step``'s from
    the same numpy weights and batch, within 2e-4 a leaf."""
    _assert_mu(stepped[2][0][i]["mu"], encdec_reference)


def test_the_seams_each_config_cuts(stepped):
    _, cases, got = stepped
    cut = {(c["arch"], c["cfg"].d_model, c["mesh"]): got[0][i]["cut"]
           for i, c in enumerate(cases)}
    # dbrx smoke: 4 experts cut over 2 and 4 ranks (expert-parallel)
    assert cut["dbrx-132b", 128, (1, 4)] == ["attn", "experts", "router",
                                             "vocab"]
    for arch in ("qwen3-1.7b", "llava-next-34b"):
        assert cut[arch, 128, (1, 4)] == ["attn", "mlp", "vocab"]
    # the SSM mixer's heads; a hybrid's shared block as a dense one's
    for d in (128, 96):
        assert cut["mamba2-2.7b", d, (1, 2)] == ["ssm", "vocab"]
    assert cut["zamba2-7b", 128, (1, 2)] == ["attn", "mlp", "ssm", "vocab"]
    assert cut["mamba2-2.7b", 128, (1, 4)] == ["ssm", "vocab"]
    # the enc-dec's three attention subtrees, two MLPs and decoder vocab
    for mesh in ((1, 2), (1, 4), (2, 2)):
        assert cut["seamless-m4t-large-v2", 128, mesh] == ["attn", "mlp",
                                                           "vocab"]
    for arch in ("qwen3-1.7b", "seamless-m4t-large-v2"):
        local = got[0][next(i for i, c in enumerate(cases)
                            if c["arch"] == arch and c["mesh"] == (1, 4))]
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


@pytest.mark.parametrize("over,mesh,cut,whole,summed", [
    # 8 heads over 4 ranks, every mixer leaf cut: nothing gathered whole
    ({}, (1, 4), {"ssm", "vocab"}, set(), set()),
    # 6 heads over 4 ranks do not divide: no "ssm" seam, and the mixer's
    # leaves that are cut (its inner channels) are gathered whole
    ({"d_model": 96}, (1, 4), {"vocab"},
     {f"blocks/mixer/{k}" for k in ("conv_w", "conv_b", "norm",
                                    "out_proj")}, set()),
    # the heads divide but in_proj's columns and the conv's channels do
    # not: those stay whole, are sliced at use and their gradients summed
    ({"ssm_state": 15}, (1, 4), {"ssm", "vocab"}, set(),
     {f"blocks/mixer/{k}" for k in ("in_proj", "conv_w", "conv_b")}),
])
def test_ssm_split_falls_back_where_a_dim_does_not_divide(over, mesh, cut,
                                                          whole, summed):
    cfg = _cfg("mamba2-2.7b", **over)
    fake = _FakeMesh(mesh)
    split = steps.model_split(cfg, fake, steps.param_shardings(cfg, fake))
    assert set(split.cut) == cut
    assert {"/".join(p) for p in split.whole} == whole
    assert {"/".join(p) for p in split.summed} == summed


#: an enc-dec's attention subtrees
ENCDEC_ATTN = ("enc_blocks/attn", "dec_blocks/attn", "dec_blocks/xattn")


@pytest.mark.parametrize("kw,cut,whole", [
    # 6 heads over 4 ranks do not divide: nothing of the three attention
    # subtrees is cut, and their compute is replicated
    (dict(n_heads=6, n_kv_heads=3), {"mlp", "vocab"}, set()),
    # 12 heads cut 4 ways, but 3 kv heads neither cut nor map a rank's
    # heads to one kv head: every subtree's wq and wo are gathered whole
    (dict(n_heads=12, n_kv_heads=3), {"mlp", "vocab"},
     {f"{t}/{k}" for t in ENCDEC_ATTN for k in ("wq", "wo")}),
])
def test_encdec_split_falls_back_where_heads_do_not_divide(kw, cut, whole):
    cfg = _cfg("seamless-m4t-large-v2", **kw)
    mesh = _FakeMesh((1, 4))
    for serving in (False, True):
        split = steps.model_split(cfg, mesh, steps.param_shardings(
            cfg, mesh), serving=serving)
        # serving has no vocab seam: its embedding and logits read the
        # vocab blocks through their own hooks (``take``, ``by_columns``)
        vocab = {"dec_embed", "lm_head"} if serving else set()
        assert set(split.cut) == (cut - {"vocab"} if serving else cut)
        assert {"/".join(p) for p in split.whole} == whole | vocab
        assert split.kv is None and split.caches == frozenset()


def test_families_the_seams_do_not_cover_split_nothing():
    """Padded heads split nothing.  seamless's smoke config (4 heads, 2 kv
    heads) cuts its attention and MLPs on every mesh its heads divide,
    and its vocab where 512 divides the ranks; its full config's vocab of
    256,206 divides 2 ranks but not 4 or 16."""
    mesh = _FakeMesh((1, 4))
    cfg = _cfg("seamless-m4t-large-v2")
    split = steps.model_split(cfg, mesh, steps.param_shardings(cfg, mesh))
    assert split.cut == {"attn", "mlp", "vocab"}
    assert split.kv == 1 and split.whole == frozenset()
    assert split.summed == {(*t.split("/"), k) for t in ENCDEC_ATTN
                            for k in ("wk", "wv")}
    full = configs.get("seamless-m4t-large-v2")
    for n, want in ((2, {"attn", "mlp", "vocab"}), (4, {"attn", "mlp"}),
                    (16, {"attn", "mlp"})):
        fake = _FakeMesh((1, n))
        split = steps.model_split(full, fake, steps.param_shardings(
            full, fake))
        # a vocab that does not divide is laid out whole: nothing to gather
        assert split.cut == want and split.whole == frozenset(), n
    # on the serving path its kv heads must be cut (2 kv heads, 2 ranks)
    # and its self and cross caches are the ranks' blocks
    fake = _FakeMesh((1, 2))
    split = steps.model_split(cfg, fake, steps.param_shardings(cfg, fake),
                              serving=True)
    assert split.cut == {"attn", "mlp"}
    assert split.caches == {("self",), ("cross",)}
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), padded_heads=8)
    assert steps.model_split(cfg, mesh,
                             steps.param_shardings(cfg, mesh)) is None
