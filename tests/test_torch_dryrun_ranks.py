"""The port's dry run held to real runs, on the CPU: the same cell counted
twice by ``launch/dryrun.StepCounter``, once on fake tensors in a fake
2-rank world (``dryrun.measure_costs``) and once on real tensors on 2 gloo
ranks (``repro_torch.dist.spawn``; the rank functions are in
tests/_torch_dryrun_ranks.py), qwen3-1.7b's smoke config in float32:

* ``sharded_train_step`` on (2, 1) and on (1, 2);
* ``prefill_step`` then ``serve_step`` on (1, 2), the params and caches
  each rank's blocks in the GSPMD serving layout.

Collective bytes by op and by axis, FLOPs, the ops' bytes, the peak of
live storage and param bytes a rank must be equal, on both ranks (the
counter runs with the cycle collector off, after a collection, so a
storage in a reference cycle is freed at the same moment every run); the
bytes the serving layout records as gathered equal the all-gathers
counted; the greedy tokens equal the one-device steps'.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dryrun_ranks as ranks  # noqa: E402

B, S, MAX_LEN = 4, 16, 32
TRAIN_MESHES = [(2, 1), (1, 2)]
SERVE_MESH = (1, 2)


def _cfg():
    return dataclasses.replace(configs.get_smoke("qwen3-1.7b"),
                               dtype="float32", param_dtype="float32")


def _params(cfg):
    return params_to_numpy(M.init_lm(cfg, seed=0, device="cpu",
                                     dtype=torch.float32))


def _flat(res, axes):
    """A counter's result as ``measure_costs`` keys."""
    out = {"flops": float(res["flops"]), "bytes": float(res["bytes"]),
           "peak": float(res["peak_bytes"])}
    for op, v in res["collective_bytes"].items():
        out[f"coll/{op}"] = v
    for axis in axes:
        per = res["collective_bytes_by_axis"].get(axis, {})
        for op in dryrun.COLLECTIVE_OPS:
            out[f"axis/{axis}/{op}"] = per.get(op, 0.0)
    return out


def _same(got: dict, want: dict) -> bool:
    """Every count equal, the peaks included."""
    return got == want


def _dry(cfg, shape, mesh_shape, **kw):
    """(the dry run's counts of the cell, the rank's param bytes)."""
    costs = dryrun.count_cell(cfg, shape, mesh_shape, ranks.AXES, **kw)
    return costs, costs.pop("param_bytes")


@pytest.fixture(scope="module")
def real():
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((B, S), np.float32)}
    tr = spawn.run(ranks.train, 2, args=(cfg, params, batch, TRAIN_MESHES),
                   device="cpu", timeout_s=120.0, deadline_s=300.0)
    sv = spawn.run(ranks.serve, 2, args=(cfg, params, toks[:, :-1],
                                         MAX_LEN, SERVE_MESH),
                   device="cpu", timeout_s=120.0, deadline_s=300.0)
    return cfg, tr, sv


@pytest.mark.parametrize("i", range(len(TRAIN_MESHES)))
def test_train_step_counts_equal_the_real_ranks(real, i):
    cfg, tr, _ = real
    shape = TRAIN_MESHES[i]
    want, pbytes = _dry(cfg, ShapeSpec("smoke", "train", S, B), shape)
    for rank in (0, 1):
        got = tr[rank][i]
        assert _same(_flat(got["counts"], ranks.AXES), want), (rank, shape)
        assert got["param_bytes"] == pbytes
        assert got["mode"] == "split"
    assert tr[0][i]["loss"] == tr[1][i]["loss"]
    # something crossed the ranks on the axis that has two: over "data"
    # the params' all-gathers; over "model" the seams' all-reduces, and no
    # leaf is gathered (the compute is split along it)
    if shape == (2, 1):
        assert want["axis/data/all-gather"] > 0
    else:
        assert want["axis/model/all-reduce"] > 0
        assert want["axis/model/all-gather"] == 0


def test_prefill_and_serve_counts_equal_the_real_ranks(real):
    cfg, _, sv = real
    pre, pbytes = _dry(cfg, ShapeSpec("smoke", "prefill", S, B), SERVE_MESH,
                       max_len=MAX_LEN)
    dec, _ = _dry(cfg, ShapeSpec("smoke", "decode", MAX_LEN, B), SERVE_MESH)
    for rank in (0, 1):
        got = sv[rank]
        assert _same(_flat(got["prefill"], ranks.AXES), pre), rank
        assert _same(_flat(got["decode"], ranks.AXES), dec), rank
        assert got["param_bytes"] == pbytes
        # the layout's own record of what it gathered is the all-gathers'
        assert got["prefill_gathered"] == got["prefill"]["collective_bytes"][
            "all-gather"] > 0
        assert got["decode_gathered"] == got["decode"]["collective_bytes"][
            "all-gather"] > 0


def test_tokens_equal_the_one_device_steps(real):
    _, _, sv = real
    for got in sv:
        np.testing.assert_array_equal(got["tokens"], got["tokens_one_device"])
