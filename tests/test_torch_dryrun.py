"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
JAX package's (``repro.launch.dryrun``), on the CPU.

What carries over is held to the reference: the 40 cells and their
rulings, the depth probes, the parameter counts (the reference's from
``init_lm_shapes`` through ``jax.eval_shape``), the model FLOPs of every
runnable cell and the param bytes a device on the production meshes (the
reference's ``resolve_spec`` on stand-in meshes, as
tests/test_torch_partition.py uses them), the collective weights (the
numbers of ``TestCollectiveParsing.test_basic_ops``, here from fake
collectives), ``prefill_step`` and ``serve_step`` on one device, and
``--list``.  Then the port's own: one full-width cell end to end in a
subprocess, the H100 roofline, the refusal of ``use_pallas`` and of a
live process group, that ``run_cell`` leaves no process group behind,
and that the SSM mixer's split along ``"model"`` shows in mamba2-2.7b's
full-size counts on the one-pod (16, 16) mesh.  (The counts against real
gloo ranks are tests/test_torch_dryrun_ranks.py.)
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import partition as jpart  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.dist import partition as tpart  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import smoke_variant  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

#: the caches' tolerance: the K/V caches agree to 1e-5, but an SSD state
#: is a sum over the chunk taken in another order in each package (zamba2's
#: 13 blocks: 3 of 98,304 elements 1.9e-5 apart, 2e-4 relative)
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tconfigs.arch_names()


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS for 512
    host devices: jax is initialized first, so that changes nothing, and
    the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return dryrun


@dataclasses.dataclass
class StandIn:
    """A production mesh as ``resolve_spec`` and ``local_shape`` see it."""

    shape: dict


MESHES = {"single": StandIn({"data": 16, "model": 16}),
          "multi": StandIn({"pod": 2, "data": 16, "model": 16})}


# ------------------------------------------------------------- carried over
def test_cells_are_the_reference(jdry):
    got, want = list(tconfigs.cells()), list(jconfigs.cells())
    assert len(got) == len(want) == 40
    assert sum(c[3] for c in got) == 33
    assert [c[2].name for c in got if not c[3]] == ["long_500k"] * 7
    for (tn, _, ts, tok, tr), (jn, _, js, jok, jr) in zip(got, want):
        assert (tn, dataclasses.asdict(ts), tok, tr) == \
            (jn, dataclasses.asdict(js), jok, jr)


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_cfg_is_the_reference(jdry, arch):
    for units in (1, 2):
        got, gu = tdry.probe_cfg(tconfigs.get(arch), units)
        want, wu = jdry.probe_cfg(jconfigs.get(arch), units)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert gu == wu
    assert tdry.probe_cfg(tconfigs.get("qwen3-1.7b"), 1)[1] == 28
    assert tdry.probe_cfg(tconfigs.get("zamba2-7b"), 2)[1] == 81 / 6
    assert tdry.probe_cfg(tconfigs.get("seamless-m4t-large-v2"), 2)[1] == 24


def _reference_counts(jdry, arch):
    cfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda: jnn.unwrap(
        JM.init_lm_shapes(jax.random.PRNGKey(0), cfg)))
    return jdry.count_params(shapes, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_are_the_reference(jdry, arch):
    tcfg = tconfigs.get(arch)
    got = tdry.count_params(TM.param_shapes(tcfg), tcfg)
    want = _reference_counts(jdry, arch)
    assert got == want
    for name, _, shape, ok, _ in jconfigs.cells():
        if name == arch and ok:
            assert tdry.model_flops(tcfg, tconfigs.SHAPES[shape.name],
                                    *got) == \
                jdry.model_flops(jconfigs.get(arch), shape, *want)


def _reference_bytes(arch, mesh, rules, itemsize):
    """Per-device bytes of the params under the reference's specs: each
    leaf's shape cut by its resolved spec, at the port's stored dtype."""
    tree = JM.init_lm_shapes(jax.random.PRNGKey(0), jconfigs.get(arch))
    axes = jax.tree_util.tree_flatten_with_path(
        jnn.axes_of(tree), is_leaf=jpart._is_axes_leaf)[0]
    shapes = dict((tuple(p.key for p in path), s.shape) for path, s in
                  jax.tree_util.tree_flatten_with_path(jnn.unwrap(tree))[0])
    total = 0
    for path, ax in axes:
        key = tuple(p.key for p in path)
        shape = shapes[key]
        spec = jpart.resolve_spec(ax, mesh, shape=shape, rules=rules)
        ways = [math.prod(mesh.shape[a] for a in
                          ((e,) if isinstance(e, str) else e or ()))
                for e in spec]
        local = [n // w for n, w in zip(shape, ways + [1] * len(shape))]
        total += math.prod(local) * itemsize["/".join(key)]
    return total


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_per_device_follow_the_reference_specs(arch, mesh_kind):
    """Training's float32 masters under the default rules, serving's
    stored params under SERVE_RULES."""
    cfg, mesh = tconfigs.get(arch), MESHES[mesh_kind]
    for psds, rules, jrules in (
            (tsteps.param_sds(cfg), None, jpart.DEFAULT_RULES),
            (tsteps.serve_param_sds(cfg), tpart.SERVE_RULES,
             jpart.SERVE_RULES)):
        pshard = tsteps.param_shardings(cfg, mesh, rules=rules)
        itemsize = {k: v.element_size() for k, v in flatten(psds).items()}
        assert tdry.bytes_per_device(psds, pshard) == \
            _reference_bytes(arch, mesh, jrules, itemsize)


def test_the_counter_applies_the_reference_weights(jdry):
    """Fake collectives at the shapes of the reference's
    ``TestCollectiveParsing.test_basic_ops`` give its numbers."""
    hlo = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%x), replica_groups={}
  %all-gather.2 = bf16[64,128]{1,0} all-gather(%y), dimensions={0}
  %reduce-scatter.3 = f32[32]{0} reduce-scatter(%z), dimensions={0}
  %collective-permute.4 = bf16[16,16]{1,0} collective-permute(%w)
  %add.5 = f32[4]{0} add(%a, %b)
"""
    want = jdry.parse_collectives(hlo)
    bf16 = torch.bfloat16
    with tdry.fake_world(2):
        counter = tdry.StepCounter()
        with counter:
            dist.all_reduce(torch.zeros(1024, 512))
            dist.all_gather([torch.zeros(32, 128, dtype=bf16)
                             for _ in range(2)],
                            torch.zeros(32, 128, dtype=bf16))
            dist.reduce_scatter(torch.zeros(32), [torch.zeros(32)] * 2)
            got = torch.zeros(16, 16, dtype=bf16)
            dist.recv(got, src=1)
            dist.send(got, dst=1)           # counted on its receiver
            torch.zeros(4) + torch.zeros(4)
    assert counter.result()["collective_bytes"] == want
    assert counter.result()["collective_bytes_by_axis"] == {
        "other": {k: v for k, v in want.items() if k != "total"}}
    assert not dist.is_initialized()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _caches(tree):
    """A cache tree with an encoder-decoder's ``cross`` tuple as a dict."""
    if isinstance(tree, dict):
        return {k: _caches(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"k": tree[0], "v": tree[1]}
    return tree


def _same_caches(got, want):
    got, want = flatten(_caches(got)), flatten(_caches(want))
    assert sorted(got) == sorted(want)
    for k in got:
        if k.endswith("len"):
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]), k)
        else:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), **CACHE_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "zamba2-7b",
                                  "seamless-m4t-large-v2", "dbrx-132b",
                                  "h2o-danube-1.8b", "llava-next-34b"])
def test_serve_steps_on_one_device_are_the_reference(arch):
    """Converted smoke params (float32), a batch of 2 prompts of 12 and two
    decode steps: logits within 1e-5, the caches after every step within
    :data:`CACHE_TOL`, their lengths exactly."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: (rng.integers(0, tcfg.vocab, r.shape).astype(np.int32)
                 if r.dtype == torch.int32 else
                 rng.standard_normal(r.shape).astype(np.float32))
             for k, r in tsteps.batch_sds(
                 tcfg, tconfigs.ShapeSpec("s", "prefill", 12, 2),
                 with_labels=False).items()}
    want, jc = jsteps.prefill_step(jp, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, cfg=jcfg, max_len=20)
    got, tc = tsteps.prefill_step(tp, {k: torch.from_numpy(v) for k, v in
                                       batch.items()}, cfg=tcfg, max_len=20)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _same_caches(tc, jc)
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for _ in range(2):
        want, jc = jsteps.serve_step(jp, jc, jnp.asarray(tok), cfg=jcfg)
        got, tc = tsteps.serve_step(tp, tc, torch.from_numpy(tok), cfg=tcfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        _same_caches(tc, jc)
        tok = np.array(jnp.argmax(want, -1), np.int32)


def test_list_prints_the_reference_lines(jdry, monkeypatch):
    want = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    with contextlib.redirect_stdout(want):
        jdry.main()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        tdry.main(["--list"])
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) == 40


# ---------------------------------------------------------- the port's own
def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def test_one_full_width_cell_end_to_end(tmp_path):
    """The reference's own slow cell, h2o-danube-1.8b x long_500k on the
    512-rank (2, 16, 16) mesh, at full width and depth; its roofline at
    the H100's rates only."""
    out = tmp_path / "r.json"
    r = _cli("--arch", "h2o-danube-1.8b", "--shape", "long_500k", "--mesh",
             "multi", "--out", str(out), cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())["h2o-danube-1.8b|long_500k|multi"]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 512 and rec["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert rec["probe"]["flops_rel_diff"] < 1e-6
    assert set(rec["collective_bytes_by_axis"]) == {"pod", "data", "model"}
    h100 = costmodel.H100
    terms = rec["roofline"]
    assert terms["compute_s"] == rec["flops_per_device"] / h100.flops
    assert terms["memory_s"] == rec["hlo_bytes_per_device"] / h100.mem_bw
    # every axis's groups cross nodes of 8 on (2, 16, 16): InfiniBand
    assert terms["collective_s"] == pytest.approx(
        rec["collective_bytes"]["total"] / h100.net_bw, rel=1e-12)
    assert rec["param_bytes_per_device"] > 0 and rec["trace_s"] > 0


def test_axis_rates_follow_the_nodes():
    h100 = costmodel.H100
    assert (h100.link_bw, h100.net_bw, h100.node_chips) == (450e9, 50e9, 8)
    mesh = StandIn({"data": 32, "model": 8})
    assert tdry.axis_rate(mesh, "model") == 450e9    # 8 ranks, one node
    assert tdry.axis_rate(mesh, "data") == 50e9
    assert tdry.axis_rate(MESHES["single"], "model") == 50e9   # 16: 2 nodes
    # the annealer's default machine keeps its one TPU rate
    assert costmodel.group_bw(costmodel.V5E, range(512)) == \
        costmodel.ICI_BW_PER_LINK
    assert costmodel.roofline_time(1, 1, 1) == costmodel.roofline_time(
        1, 1, 1, machine=costmodel.V5E)


def test_use_pallas_is_refused_before_any_step(tmp_path):
    with pytest.raises(ValueError, match="shape-only"):
        tdry.run_cell("qwen3-1.7b", "decode_32k", "single", verbose=False,
                      overrides={"use_pallas": "true"})
    r = _cli("--arch", "qwen3-1.7b", "--shape", "decode_32k", "--override",
             "use_pallas=true", "--out", str(tmp_path / "r.json"),
             cwd=tmp_path)
    assert r.returncode == 2 and "shape-only" in r.stderr
    assert not (tmp_path / "r.json").exists()
    assert not dist.is_initialized()


@pytest.fixture
def smoke_configs(monkeypatch):
    """``configs.get`` at the smoke width: a production mesh cell in a few
    seconds."""
    whole = tconfigs.get
    monkeypatch.setattr(tdry.configs, "get",
                        lambda name: smoke_variant(whole(name)))


def test_run_cell_leaves_no_process_group(smoke_configs, monkeypatch):
    rec = tdry.run_cell("qwen3-1.7b", "decode_32k", "single", verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert not dist.is_initialized()

    def broken(*a, **kw):
        raise RuntimeError("a failing step")
    monkeypatch.setattr(tdry.steps, "serve_step", broken)
    with pytest.raises(RuntimeError, match="a failing step"):
        tdry.run_cell("qwen3-1.7b", "decode_32k", "multi", verbose=False)
    assert not dist.is_initialized()


def test_run_cell_refuses_a_live_process_group(smoke_configs):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            tdry.run_cell("qwen3-1.7b", "decode_32k", "single",
                          verbose=False)
        assert dist.get_world_size() == 1       # left as it was
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"),
                                        ("dbrx-132b", "prefill_32k"),
                                        ("zamba2-7b", "decode_32k"),
                                        ("seamless-m4t-large-v2",
                                         "train_4k")])
def test_probes_extrapolate_to_the_full_count(smoke_configs, arch, shape):
    """At smoke width on the 256-rank mesh: the depth-1/2 extrapolation is
    the full-depth count (a hybrid's trailing blocks aside), and the
    record keeps the reference's keys."""
    rec = tdry.run_cell(arch, shape, "single", verbose=False)
    for key in ("status", "chips", "memory_per_device_bytes",
                "flops_per_device", "hlo_bytes_per_device",
                "collective_bytes", "probe", "param_bytes_per_device",
                "params_total", "params_active", "roofline",
                "model_flops_total", "useful_flops_ratio", "trace_s",
                "collective_bytes_by_axis"):
        assert key in rec, key
    assert ("num_microbatches" in rec) == (shape == "train_4k")
    if arch != "zamba2-7b":
        assert rec["probe"]["flops_rel_diff"] < 1e-6, rec["probe"]
    assert rec["collective_bytes"]["total"] == pytest.approx(sum(
        v["total"] for v in rec["collective_bytes_by_axis"].values()))


# --------------------------------------------------- the SSM mixer's split
#: mamba2-2.7b's counts a device on the one-pod (16, 16) mesh while the
#: mixer's compute was replicated along "model" (every layer gathered whole
#: there): train_4k FLOPs and peak, decode_32k's bytes over "model" a step
REPLICATED = {"train_flops": 1.488e15, "train_peak": 101.0e9,
              "decode_model_bytes": 4.93e9}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_the_ssm_split_shows_in_mamba2s_full_size_counts(shape):
    """At full width, on fake tensors, all 64 layers by the reference's
    depth probes (``extrapolated_costs``: counted at depths 1 and 2, exact
    for a homogeneous stack; the full-depth count of train_4k gives the
    same FLOPs and peak and takes 6 times as long): each rank of train_4k
    computes its heads (at most a quarter of the replicated FLOPs, a lower
    peak), and a decode_32k step moves under a tenth of the replicated
    bytes over "model" (the re-lays' all-to-alls and the seams, no leaf
    gathered whole)."""
    cfg = tconfigs.get("mamba2-2.7b")
    with tdry.fake_world(256):
        costs = tdry.extrapolated_costs(
            cfg, tconfigs.SHAPES[shape],
            tdry.fake_mesh((16, 16), ("data", "model")))
    if shape == "train_4k":
        assert costs["flops"] <= REPLICATED["train_flops"] / 4
        assert costs["peak"] < REPLICATED["train_peak"]
    else:
        model = {k.rsplit("/", 1)[1]: v for k, v in costs.items()
                 if k.startswith("axis/model/")}
        assert model["all-gather"] == 0 and model["all-to-all"] > 0
        assert sum(model.values()) < REPLICATED["decode_model_bytes"] / 10
