"""Tensor-parallel serving in the port: ``ContinuousEngine(mesh=)`` over 2
and 4 ranks (gloo on loopback, one process a rank), paged and contiguous,
fifo and reversed arrivals, on dense, MoE (capacity factor 4.0: no
dispatch drops a copy) and VLM smoke configs with 8 query and 4 kv heads.
Every rank's greedy tokens equal the 1-device port engine's and the JAX
package's single-request ``Engine.generate`` on the same weights; with
int8-compressed seams every request is served and the ranks still agree.
``tp_mode="gspmd"`` and the configs the manual path cannot shard take the
GSPMD path (``tests/test_torch_serve_gspmd.py`` holds its tokens), and
``launch.serve --mesh 2`` prints its JSON line, with ``--autotune`` too
and on such a config."""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.serve import engine as tengine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: 8 query and 4 kv heads, so that both mesh widths shard every seam dim
HEADS = dict(n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16)
CASES = {"dense": ("qwen3-1.7b", HEADS),
         "moe": ("dbrx-132b", {**HEADS, "capacity_factor": 4.0}),
         "vlm": ("llava-next-34b", HEADS)}
MAX_LEN = 48
ENGINES = {"paged": dict(max_len=MAX_LEN, capacity=3, paged=True,
                         page_size=8, prefill_chunk=16),
           "contiguous": dict(max_len=MAX_LEN, capacity=3)}
#: (engine, order, compressed) of every run a job makes, in order
RUNS = [("paged", "fifo", False), ("paged", "reversed", False),
        ("contiguous", "fifo", False), ("contiguous", "reversed", False),
        ("paged", "fifo", True)]
EXACT = [r for r in RUNS if not r[2]]
TIMEOUT_S, DEADLINE_S = 30.0, 240.0


def _requests(cfg, seed: int):
    """Prompts of 20, 37 (past the 16-token chunk), 20 (one prefill group
    with the first), 9 and 12 tokens, and one sharing the first's two
    pages (a VLM's with embeddings of its own: no prefix hit)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for n, b in ((20, 6), (37, 5), (20, 7), (9, 4), (12, 6)):
        p = rng.integers(1, cfg.vocab, n).astype(np.int32)
        reqs.append([p, b, None])
    reqs.append([np.concatenate([reqs[0][0][:17], [5, 7, 9]])
                 .astype(np.int32), 5, None])
    if cfg.input_mode == "embeddings":
        for r in reqs:
            r[2] = {"embeds": rng.standard_normal(
                (len(r[0]), cfg.d_model)).astype(np.float32)}
    return [tuple(r) for r in reqs]


def _scfg(engine: str, compressed: bool = False) -> tengine.ServeConfig:
    return tengine.ServeConfig(**ENGINES[engine],
                               compressed_collectives=compressed)


def _serve_1dev(params, cfg, scfg, reqs, order):
    eng = tengine.ContinuousEngine(params, cfg, scfg)
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(*reqs[i][:2], extra=reqs[i][2]).uid: i
                  for i in idxs}
    got = eng.run(max_steps=1000)
    return {i: got[u].tolist() for u, i in uid_to_idx.items()}


@pytest.fixture(scope="module")
def served():
    """Per case: the requests, the reference's single-request tokens, the
    1-device port engine's tokens per exact run, and per mesh width every
    rank's tokens per run (one job per width runs every case)."""
    cases, payload = {}, []
    for name, (arch, over) in CASES.items():
        jcfg = jconfigs.get_smoke(arch, **over)
        cfg = tconfigs.get_smoke(arch, **over)
        # the port's random weights, carried over to the reference (its
        # own init compiles for seconds a config)
        params_np = params_to_numpy(tm.init_lm(cfg, seed=3, device="cpu"))
        jp = jax.tree.map(jnp.asarray, params_np)
        reqs = _requests(cfg, seed=len(payload))
        ref = jengine.Engine(jp, jcfg, jengine.ServeConfig(max_len=MAX_LEN))
        want = [np.asarray(ref.generate(
            p[None], b, extra_inputs={k: v[None] for k, v in e.items()}
            if e else None)[0]).tolist() for p, b, e in reqs]
        tp = params_from_numpy(params_np, cfg, device="cpu")
        one = {(e, o): _serve_1dev(tp, cfg, _scfg(e), reqs, o)
               for e, o, _ in EXACT}
        cases[name] = {"cfg": cfg, "requests": reqs, "reference": want,
                       "one_device": one}
        payload.append({"cfg": cfg, "params": params_np, "requests": reqs,
                        "runs": [(_scfg(e, c), o) for e, o, c in RUNS]})
    # both widths' jobs at once: their ranks are single-threaded
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(spawn.run, ranks.serve_runs, n,
                                  args=(payload,), timeout_s=TIMEOUT_S,
                                  deadline_s=DEADLINE_S) for n in (2, 4)}
        jobs = {n: f.result() for n, f in futures.items()}
    return cases, jobs


def _runs(served, case: str, n: int):
    """[rank][run] of ``case`` at mesh width ``n``."""
    cases, jobs = served
    i = list(CASES).index(case)
    return [job[i] for job in jobs[n]]


@pytest.mark.parametrize("engine,order", [(e, o) for e, o, _ in EXACT])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_tp_tokens_equal_reference_and_one_device(served, case, n, engine,
                                                  order):
    c = served[0][case]
    run = RUNS.index((engine, order, False))
    for rank, runs in enumerate(_runs(served, case, n)):
        got = runs[run]["tokens"]
        for i, want in enumerate(c["reference"]):
            assert got[i] == want, (rank, i)
            assert got[i] == c["one_device"][engine, order][i], (rank, i)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_and_hold_their_kv_heads(served, case, n):
    per_rank = _runs(served, case, n)
    cfg = served[0][case]["cfg"]
    for runs in per_rank[1:]:
        assert [r["tokens"] for r in runs] == \
            [r["tokens"] for r in per_rank[0]]
    for runs in per_rank:
        assert {r["kv_heads"] for r in runs} == {cfg.n_kv_heads // n}
        assert {r["tp_path"] for r in runs} == {"shard_map"}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_compressed_seams_serve_every_request(served, case, n):
    reqs = served[0][case]["requests"]
    run = RUNS.index(("paged", "fifo", True))
    got = [runs[run]["tokens"] for runs in _runs(served, case, n)]
    assert all(g == got[0] for g in got)
    for i, (_, budget, _) in enumerate(reqs):
        assert len(got[0][i]) == budget
        assert all(0 <= t < served[0][case]["cfg"].vocab for t in got[0][i])


# ============================================= which path, and what is refused
def _mesh(n: int = 2) -> Mesh:
    """A rank's mesh view without a process group: enough to build an
    engine, which runs no collective before its first dispatch."""
    return Mesh(shape={"model": n}, rank=0, device=torch.device("cpu"),
                backend="gloo", groups={"model": None}, coords={"model": 0})


@pytest.fixture(scope="module")
def small():
    cfg = tconfigs.get_smoke("qwen3-1.7b")
    return cfg, tengine.ServeConfig(max_len=32, capacity=2)


def test_gspmd_raises(small):
    """A config the manual path could shard, forced onto the GSPMD path:
    the engine keeps its blocks of the global config's params."""
    cfg, scfg = small
    params = tm.init_lm(cfg, device="cpu")
    eng = tengine.ContinuousEngine(params, cfg, dataclasses.replace(
        scfg, tp_mode="gspmd"), mesh=_mesh())
    assert (eng.tp_path, eng.tp_reason) == ("gspmd", "ok")
    assert eng.cfg.n_heads == cfg.n_heads and eng.layout is not None
    assert eng.params["lm_head"].shape[1] == cfg.vocab // 2


@pytest.mark.parametrize("arch,over,reason", [
    ("mamba2-2.7b", {}, "family 'ssm' not in"),
    ("qwen3-1.7b", {"padded_heads": 8}, "padded_heads uses a q->kv head map"),
    ("qwen3-1.7b", {}, "n_kv_heads=2 not divisible by 4 shards")])
def test_ineligible_configs_raise(arch, over, reason):
    """Each takes the GSPMD path, naming why; only forcing the manual path
    raises."""
    cfg = tconfigs.get_smoke(arch, **over)
    params = tm.init_lm(cfg, device="cpu")
    scfg = tengine.ServeConfig(max_len=32, capacity=2)
    eng = tengine.ContinuousEngine(params, cfg, scfg, mesh=_mesh(4))
    assert eng.tp_path == "gspmd" and reason in eng.tp_reason
    with pytest.raises(ValueError, match="tp_mode='shard_map' but"):
        tengine.ContinuousEngine(params, cfg, dataclasses.replace(
            scfg, tp_mode="shard_map"), mesh=_mesh(4))


def test_compressed_collectives_need_a_mesh(small):
    cfg, scfg = small
    params = tm.init_lm(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires a serving mesh"):
        tengine.ContinuousEngine(params, cfg, dataclasses.replace(
            scfg, compressed_collectives=True))


@pytest.mark.parametrize("flags,message", [
    (["--autotune", "--mesh", "2"], "--autotune requires --sip-cache"),
    (["--static", "--mesh", "2"], "--mesh requires the continuous engine"),
    (["--compressed-collectives"], "--compressed-collectives requires "
                                   "--mesh")])
def test_launcher_refuses(flags, message, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def _launch(*flags: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", *flags],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)


def _report(out: subprocess.CompletedProcess) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[serve:continuous] ")]
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0].split(" ", 1)[1])


def test_launcher_serves_on_a_mesh_of_2():
    report = _report(_launch("--arch", "qwen3-1.7b", "--paged", "--mesh",
                             "2", "--requests", "8", "--capacity", "3"))
    assert report["mesh"] == [2] and report["tp_path"] == "shard_map"
    assert report["tp_reason"] == "ok"
    assert report["backend"] == "gloo" and report["tokens"] > 0


def test_launcher_autotunes_on_a_mesh_of_2(tmp_path):
    """``--autotune`` with ``--mesh``: the service tunes on rank 0 beside a
    sharded engine and the job serves every request, the ranks' tokens
    equal (the launcher compares them)."""
    cache = tmp_path / "live.json"
    out = _launch("--arch", "qwen3-1.7b", "--paged", "--prefill-chunk",
                  "16", "--mesh", "2", "--requests", "8", "--capacity", "3",
                  "--sip-cache", str(cache), "--autotune",
                  "--autotune-interval", "1")
    report = _report(out)
    assert report["tp_path"] == "shard_map" and report["tokens"] > 0
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[serve] autotune: ")]
    assert len(lines) == 1, out.stdout
    metrics = json.loads(lines[0].split(" ", 2)[2])
    assert metrics["cycles"] >= 1 and metrics["errors"] == 0
    assert (tmp_path / "live.json.autotune.jsonl").exists()


def test_launcher_mesh_fails_on_an_ineligible_config(capfd):
    """mamba2 cannot shard on the manual path: the job takes the GSPMD
    path, names why, and serves on both ranks; it does not fall back to
    one rank."""
    tserve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                 "--mesh", "2", "--requests", "2"])
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("[serve:continuous] ")]
    assert len(lines) == 1
    report = json.loads(lines[0].split(" ", 1)[1])
    assert report["mesh"] == [2] and report["tp_path"] == "gspmd"
    assert "family 'ssm' not in" in report["tp_reason"]
    assert report["tokens"] > 0
