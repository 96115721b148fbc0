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


def test_train_launcher_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default succeeds")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-1.7b", "--smoke", "--steps", "2", "--batch", "2", "--seq",
           "16", "--ckpt-dir", str(tmp_path / "ck")]
    bad = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert bad.returncode != 0
    assert "CUDA is not available" in bad.stderr
    assert "[train] done" not in bad.stdout
    ok = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                        text=True, env=_env(), timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "[train] done" in ok.stdout


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


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_encoder_bound_and_traffic():
    """The bidirectional flash row's bound at seamless's encoder shape is
    set by operations: 4 * 16 * 4096**2 * 64 = 68.7 GFLOP at 989 TFLOP/s
    dense bf16, 0.0695 ms, and at a rank's 8 heads half of it.  The
    enc-dec traffic: 17 requests, prompts 4-32 tokens with the first two
    of 8 (one grouped prefill), 32-64 new tokens, each with its own
    (enc_len, d_model) float32 context; the mesh serving job's, its first
    three with 2-4 new tokens."""
    import numpy as np
    smoke = _chip_smoke()
    b, hq, hkv, s, d = smoke.FLASH_ENCODER_SHAPE
    ms, by = smoke.attention_bound_ms(b, hq, hkv, s, s, d, 2, False, None,
                                      smoke.PEAK_FLOPS[torch.bfloat16])
    assert by == "operations"
    assert abs(ms - 4 * 16 * 4096 ** 2 * 64 / 989e12 * 1e3) < 1e-12
    assert abs(ms - 0.0695) < 1e-4
    # a rank's 8 of the 16 heads when the encoder splits over 2 ranks
    b, hq, hkv, s, d = smoke.FLASH_ENCODER_RANK_SHAPE
    assert (hq, hkv) == (8, 8)
    half, by = smoke.attention_bound_ms(b, hq, hkv, s, s, d, 2, False, None,
                                        smoke.PEAK_FLOPS[torch.bfloat16])
    assert by == "operations" and abs(half - ms / 2) < 1e-12
    cfg = configs.get_smoke("seamless-m4t-large-v2")
    prompts, budgets, extras = smoke._encdec_requests(cfg)
    lens = [len(p) for p in prompts]
    assert len(prompts) == len(budgets) == len(extras) == 17
    assert lens[:2] == [8, 8] and 4 <= min(lens) and max(lens) <= 32
    assert 32 <= min(budgets) and max(budgets) <= 64
    assert max(lens) + max(budgets) <= smoke.SERVE_ENCDEC.max_len
    ctx = [e["enc_embeds"] for e in extras]
    assert all(c.shape == (cfg.enc_len, cfg.d_model)
               and c.dtype == np.float32 for c in ctx)
    assert not np.array_equal(ctx[0], ctx[1])
    # the mesh serving job's seamless requests: the first three, 2-4 new
    prompts, budgets, extras = smoke._gspmd_encdec_requests(cfg)
    assert [len(p) for p in prompts] == lens[:3] and budgets == [2, 3, 4]
    assert len(extras) == 3


def test_chip_smoke_counts_every_kernel_under_its_row():
    """Every launch counter reaches the kernels line under its row's
    name: flash by (causal, dtype) into four rows, the others by their
    function names, and ``reset_launches`` zeroes them all."""
    smoke = _chip_smoke()
    fa = smoke.fa
    assert set(smoke.FLASH_ROWS) == set(fa.variant_launches)
    fa.variant_launches[False, "bfloat16"] += 3
    smoke.pg.launches += 2
    rows = smoke.row_launches()
    assert rows["flash_attention"] == 3 and rows["paged_gather"] == 2
    assert set(rows) == {"flash_attention", "flash_attention_causal",
                         "flash_attention_f32", "flash_attention_causal_f32",
                         "gemm_fused_leaky_relu", "paged_gather",
                         "ssd_intra_chunk", "rmsnorm_fused"}
    smoke.reset_launches()
    assert not any(smoke.row_launches().values())
