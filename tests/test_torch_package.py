"""Package-level properties of the PyTorch/CUDA port: it imports neither JAX
nor the JAX package, its entry points refuse to run without a card unless
asked for the CPU, its build names Hopper's target and fails clearly
without ``nvcc``, and ``chip_smoke.py`` fails without a card or the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_imports(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_init_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default succeeds")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_lm(configs.get_smoke("qwen3-1.7b"))


def test_serve_launcher_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default succeeds")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-1.7b", "--smoke", "--requests", "2"]
    bad = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert bad.returncode != 0
    assert "[serve:continuous]" not in bad.stdout
    ok = subprocess.run(cmd + ["--device", "cpu", "--paged",
                               "--new-tokens", "2"],
                        capture_output=True, text=True, env=_env(),
                        timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "[serve:continuous]" in ok.stdout


def test_build_targets_hopper():
    cmd = _build.nvcc_command("nvcc", Path("x.cu"), Path("x.cubin"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-cubin", "-O3", "-std=c++17"} <= set(cmd)
    templates = {p.name for p in _build.CSRC.glob("*.cu")}
    assert templates == {"flash_attention.cu", "flash_attention_f32.cu",
                         "gemm_fused.cu", "paged_gather.cu", "rmsnorm.cu",
                         "ssd_intra.cu"}
    for name in templates:
        text = _build.template(name)
        assert "sm_90a" in text
        # float32 flash's operand path is emitted ahead of the flash
        # template, whose body mark serves both dtypes
        assert ("/*@BODY@*/" in text) == (name != "flash_attention_f32.cu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_kernels", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.compile_many([("paged_gather", "// text")])
    assert not list(tmp_path.iterdir())


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert here.returncode != 0
    assert '"ok": true' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, timeout=120,
                           cwd=tmp_path, env={"PATH": os.environ["PATH"]})
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


def test_chip_smoke_trace_totals_match_key_averages():
    """The profile phases read their sums from the raw trace
    (``chip_smoke.trace_totals``): each ATen op's host self time and call
    count are key_averages()'s, here on a CPU serving window."""
    import importlib.util
    from torch.profiler import ProfilerActivity, profile

    import numpy as np
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = configs.get_smoke("dbrx-132b")
    eng = ContinuousEngine(M.init_lm(cfg, seed=0, device="cpu"), cfg,
                           ServeConfig(max_len=64, capacity=2, paged=True,
                                       page_size=8, prefill_chunk=16))
    rng = np.random.default_rng(0)
    for n in (12, 30):
        eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32), 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(max_steps=100)
    rows, host = smoke.trace_totals(prof)
    want = {ev.key: (ev.self_cpu_time_total, ev.count)
            for ev in prof.key_averages() if ev.key.startswith("aten::")}
    assert rows == [] and {k for _, _, k in host} == set(want)
    for us, calls, name in host:
        assert calls == want[name][1], name
        assert abs(us - want[name][0]) <= 1e-3 * want[name][0] + 1.0, name
