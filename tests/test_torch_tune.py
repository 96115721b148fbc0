"""The port's tuning drivers on the CPU: ``repro_torch.launch.tune --smoke
--device cpu`` persists the same (kernel, signature, knobs, order, energy,
tests_passed) as the JAX package's ``TuningSession`` over the same kernels;
``verify`` passes on the tuned store; a ``--die-after 1`` run resumed with
``--resume`` leaves a cache byte-identical to an uninterrupted run; ``--list``
shows the registered kernels; serving reads the store with ``--sip-cache``;
tune, verify and the autotune daemon refuse CUDA without a card; mamba2
serves on the CPU; the daemon tunes a stream the server recorded; and what
is not ported raises."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import kernels as jkernels  # noqa: E402
from repro.core.jit import TuneConfig  # noqa: E402
from repro.tuning.session import TuningSession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["flash_attention", "flash_attention_causal", "gemm_fused_leaky_relu",
         "paged_gather", "rmsnorm_fused", "ssd_intra_chunk"]
#: the registered names with a smoke workload (flash_attention has none)
SMOKE = 5


def _run(module, *args, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}",
                          *args], capture_output=True, text=True, env=env,
                         timeout=240)
    if check:
        assert res.returncode == 0, res.stdout + res.stderr
    return res


def _entries(data):
    return sorted((key, json.loads(e["schedule_json"]), e["energy"],
                   e["tests_passed"]) for key, es in data.items() for e in es)


@pytest.fixture(scope="module")
def smoke_cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("tune") / "cache.json"
    _run("tune", "--smoke", "--device", "cpu", "--cache", str(path))
    return path


def test_smoke_tune_persists_what_the_reference_session_does(smoke_cache):
    jkernels.load_all()
    # launch/tune.py --smoke's configuration
    session = TuningSession(config=TuneConfig(
        rounds=1, t_min=0.3, cooling=1.3, final_samples=4, step_samples=1))
    session.run(kernels=NAMES, suite="smoke")
    got = _entries(json.loads(smoke_cache.read_text()))
    want = _entries(session.cache._data)
    assert len(got) == len(want) == SMOKE
    for (gk, gs, ge, gp), (wk, ws, we, wp) in zip(got, want):
        assert (gk, gs, gp) == (wk, ws, wp)
        assert ge == pytest.approx(we, rel=1e-9)
    assert all(p for *_, p in got)


def test_verify_passes_on_the_tuned_store(smoke_cache):
    res = _run("verify", "--suite", "smoke", "--device", "cpu", "--cache",
               str(smoke_cache))
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[verify] ")]
    assert sum("PASS" in ln and "tuned schedule" in ln
               for ln in lines) == SMOKE
    assert lines[-1] == \
        f"[verify] {SMOKE} workload(s) passed the correctness gate"


def test_die_after_then_resume_is_byte_identical(smoke_cache, tmp_path):
    path = tmp_path / "chaos.json"
    died = _run("tune", "--smoke", "--device", "cpu", "--cache", str(path),
                "--die-after", "1", check=False)
    assert died.returncode == 3, died.stdout + died.stderr
    state = json.loads((tmp_path / "chaos.json.state.json").read_text())
    assert state["in_progress"] is not None
    _run("tune", "--smoke", "--device", "cpu", "--cache", str(path),
         "--resume")
    assert path.read_bytes() == smoke_cache.read_bytes()


def test_list_shows_the_registered_kernels():
    res = _run("tune", "--list")
    listed = [ln.split()[0] for ln in res.stdout.splitlines()
              if ln and not ln.startswith(" ")]
    assert listed == NAMES
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.tune",
                          "--list"], capture_output=True, text=True,
                         env=env, timeout=240)
    assert ref.returncode == 0, ref.stderr
    assert listed == [ln.split()[0] for ln in ref.stdout.splitlines()
                      if ln and not ln.startswith(" ")]


def test_drivers_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default succeeds")
    for module, args in (("tune", ["--smoke", "--cache",
                                   str(tmp_path / "c.json")]),
                         ("verify", ["--suite", "smoke"])):
        res = _run(module, *args, check=False)
        assert res.returncode != 0
        assert "CUDA" in res.stderr and "PASS" not in res.stdout


def test_serve_runs_from_the_tuned_store(smoke_cache):
    res = _run("serve", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--paged", "--prefill-chunk", "16", "--requests", "3",
               "--capacity", "2", "--new-tokens", "2", "--sip-cache",
               str(smoke_cache))
    (line,) = [ln for ln in res.stdout.splitlines()
               if ln.startswith("[serve:continuous] ")]
    assert json.loads(line.split(" ", 1)[1])["tokens"] == 6


def test_serve_mamba2_smoke_on_cpu():
    """The SSM family serves through the contiguous engine; paged serving
    refuses it."""
    res = _run("serve", "--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
               "--requests", "3", "--capacity", "2", "--new-tokens", "2")
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("[serve:continuous] ")]
    assert len(lines) == 1
    assert json.loads(lines[0].split(" ", 1)[1])["tokens"] == 6
    res = _run("serve", "--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
               "--requests", "1", "--paged", check=False)
    assert res.returncode != 0
    assert ("paged serving supports ('dense', 'moe', 'vlm'), not 'ssm'"
            in res.stderr)


def test_train_launcher_trains_on_cpu(tmp_path):
    """Four supervised steps of qwen3's smoke config on the CPU: the final
    loss is below the first step's."""
    res = _run("train", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--steps", "4", "--batch", "8", "--seq", "32", "--ckpt-dir",
               str(tmp_path / "ck"))
    first = re.search(r"\[train\] step 1/4 loss=([0-9.]+)", res.stdout)
    last = re.search(r"\[train\] done: final loss ([0-9.]+) at step 4",
                     res.stdout)
    assert first and last, res.stdout
    assert float(last.group(1)) < float(first.group(1))


def test_train_launcher_trains_on_a_host_mesh(tmp_path):
    """``--mesh host`` over 2 CPU ranks: sharded steps on a (2, 1) mesh, a
    checkpoint, and one ``done`` line from rank 0."""
    res = _run("train", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--mesh", "host", "--ranks", "2", "--steps", "3", "--batch",
               "4", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
               str(tmp_path / "ck"))
    done = re.findall(r"\[train\] done: final loss ([0-9.]+) at step 3.*"
                      r"mesh=\[2, 1\]", res.stdout)
    assert len(done) == 1, res.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_00000002",
                                                   "step_00000003"]


def test_train_launcher_refuses_a_production_mesh():
    res = _run("train", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--steps", "1", "--mesh", "single", "--ranks", "2",
               check=False)
    assert res.returncode != 0
    assert "--mesh single needs 256 ranks" in res.stderr


def test_autotune_daemon_tunes_a_recorded_stream(tmp_path):
    """``launch.serve --record-workloads`` streams the mix; the daemon tails
    it for one cycle, promotes into its store and journals what it did."""
    mix, cache = tmp_path / "mix.jsonl", tmp_path / "live.json"
    _run("serve", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
         "--paged", "--requests", "3", "--capacity", "2", "--new-tokens",
         "2", "--record-workloads", str(mix))
    res = _run("autotune", "--arch", "qwen3-1.7b", "--smoke", "--device",
               "cpu", "--cycles", "1", "--paged", "--capacity", "2",
               "--cache", str(cache), "--recorder", str(mix))
    (line,) = [ln for ln in res.stdout.splitlines()
               if ln.startswith("[autotune] {")]
    summary = json.loads(line.split(" ", 1)[1])
    assert summary["tuned"] == summary["promoted"] == 2
    journal = str(cache) + ".autotune.jsonl"
    rep = _run("obsreport", journal, "--kind", "autotune", "--validate")
    assert rep.stdout.strip().endswith(": OK")
    assert len(json.loads(cache.read_text())) == 2


def test_serve_runs_the_autotune_service(tmp_path):
    """``launch.serve --autotune`` tunes the live mix on a background thread
    while it serves, journals every decision and streams the mix."""
    live, mix = tmp_path / "live.json", tmp_path / "mix.jsonl"
    res = _run("serve", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--paged", "--prefill-chunk", "16", "--requests", "8",
               "--capacity", "3", "--sip-cache", str(live), "--autotune",
               "--autotune-interval", "0.2", "--record-workloads", str(mix))
    (line,) = [ln for ln in res.stdout.splitlines()
               if ln.startswith("[serve] autotune: ")]
    metrics = json.loads(line.split(": ", 1)[1])
    assert metrics["cycles"] >= 1 and metrics["errors"] == 0
    journal = str(live) + ".autotune.jsonl"
    assert _run("obsreport", journal, "--kind", "autotune",
                "--validate").returncode == 0
    assert _run("obsreport", str(mix), "--kind", "workloads",
                "--validate").returncode == 0


@pytest.mark.parametrize("extra,error", [
    ([], "--autotune requires --sip-cache"),
    (["--sip-cache", "x.json", "--static"],
     "--autotune requires the continuous engine")])
def test_serve_refuses_autotune_without_a_live_engine(extra, error):
    res = _run("serve", "--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--autotune", *extra, check=False)
    assert res.returncode != 0 and error in res.stderr


def test_autotune_daemon_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default succeeds")
    res = _run("autotune", "--arch", "qwen3-1.7b", "--smoke", "--cycles",
               "1", "--cache", str(tmp_path / "c.json"), "--recorder",
               str(tmp_path / "mix.jsonl"), check=False)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "[autotune] {" not in res.stdout
