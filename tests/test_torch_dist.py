"""The port's distributed serving pieces against the JAX package's: int8
quantization bit for bit, the compressed all-reduce over 2 and 4 ranks,
the TP eligibility gate and the logical-axes trees of every config, and
manual tensor parallelism on ``tests/sharded_subprocess.py::tp_parity``'s
config (greedy tokens equal the reference's single-device tokens, logits
within 1e-4, compressed seams within 5e-2 relative).  Also the job
launcher's failure modes (a rank that raises, ranks that disagree on their
collectives, a deadline) and the mesh's axis groups.

Ranks are processes on this host talking over gloo on loopback
(``repro_torch.dist.spawn``); their functions are in ``_torch_tp_ranks``."""

import concurrent.futures
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.dist import tp as jtp  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import collectives as tcoll  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist import tp as ttp  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

#: tests/sharded_subprocess.py::tp_parity's config
PARITY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=8,
              n_kv_heads=4, d_ff=256, vocab=128, dtype="float32")
MAX_LEN, N_DECODE = 24, 4
#: seconds: a rank's collective timeout and a job's deadline in these tests
TIMEOUT_S, DEADLINE_S = 20.0, 120.0


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _axes_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)[0]
    return [(jax.tree_util.keystr(p), a) for p, a in flat]


# ============================================================ quantization
QUANT_CASES = {"normal_1000": (np.random.default_rng(0).standard_normal(
                   1000).astype(np.float32), 64),
               "wide_2d_block32": (np.random.default_rng(1).standard_normal(
                   (7, 45)).astype(np.float32) * 1e3, 32),
               "halves": (np.arange(-130, 130, dtype=np.float32) / 2, 64),
               "zeros": (np.zeros(100, np.float32), 64)}


def _nonfinite_cases():
    """The inputs of tests/test_collectives.py::TestNonFiniteContract."""
    a = np.linspace(-2.0, 2.0, 64).astype(np.float32)
    a[13] = np.nan
    b = np.linspace(-1.0, 1.0, 64).astype(np.float32)
    b[0], b[1] = np.inf, -np.inf
    c = np.full((64,), 0.5, np.float32)
    c[7] = np.inf
    d = np.full((64,), np.nan, np.float32)
    d[::2] = np.inf
    e = np.ones((128,), np.float32)
    e[3] = np.nan
    f = np.r_[np.nan, np.inf, np.ones(62)].astype(np.float32)
    return {"nan": a, "inf": b, "scale_ignores_inf": c, "all_nonfinite": d,
            "nan_one_block": e, "psum_input": f}


QUANT_CASES.update({k: (v, 64) for k, v in _nonfinite_cases().items()})


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_matches_reference(case):
    x, block = QUANT_CASES[case]
    jq, js, jpad = jcoll.quantize_int8(jnp.asarray(x), block)
    tq, ts, tpad = tcoll.quantize_int8(torch.from_numpy(x), block)
    assert tpad == jpad and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    want = np.asarray(jcoll.dequantize_int8(jq, js, jpad, x.shape))
    got = tcoll.dequantize_int8(tq, ts, tpad, x.shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert np.isfinite(got).all()
    assert tcoll.compression_ratio(torch.from_numpy(x), block) == \
        pytest.approx(jcoll.compression_ratio(jnp.asarray(x), block))


def test_nonfinite_contract():
    """The reference's contract, on the port: NaN -> 0, ±Inf clamps to the
    finite extreme, one bad element never leaves its block."""
    cases = _nonfinite_cases()
    q, s, pad = tcoll.quantize_int8(torch.from_numpy(cases["nan"]))
    y = tcoll.dequantize_int8(q, s, pad, (64,)).numpy()
    assert y[13] == 0.0 and np.isfinite(y).all()
    x = cases["inf"]
    q, s, pad = tcoll.quantize_int8(torch.from_numpy(x))
    y = tcoll.dequantize_int8(q, s, pad, (64,)).numpy()
    amax = np.max(np.abs(x[2:]))
    np.testing.assert_allclose(y[:2], [amax, -amax], rtol=1e-2)
    _, s, _ = tcoll.quantize_int8(torch.from_numpy(
        cases["scale_ignores_inf"]))
    np.testing.assert_allclose(s.numpy(), 0.5 / 127.0, rtol=1e-6)
    q, s, pad = tcoll.quantize_int8(torch.from_numpy(cases["all_nonfinite"]))
    np.testing.assert_array_equal(
        tcoll.dequantize_int8(q, s, pad, (64,)).numpy(), 0.0)
    q, s, pad = tcoll.quantize_int8(torch.from_numpy(cases["nan_one_block"]))
    np.testing.assert_allclose(
        tcoll.dequantize_int8(q, s, pad, (128,)).numpy()[64:], 1.0,
        rtol=1e-2)


def test_half_to_even_rounding():
    """x / scale at exact halves rounds to even, as jnp.round does."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0] + [0.0] * 58)
    q, s, _ = tcoll.quantize_int8(x)
    assert s[0].item() == pytest.approx(1.0)
    assert q[0, :5].tolist() == [0, 2, 2, 0, -2]


# ================================================== ranks: the parity job
@pytest.fixture(scope="module")
def parity():
    """The reference's single-device greedy run and its params, and one
    job per mesh width running the compressed all-reduce and the manual
    TP model on the same weights and inputs."""
    jcfg = JConfig(**PARITY).validate()
    cfg = ModelConfig(**PARITY).validate()
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, (2, 16)).astype(np.int32)
    logits, caches = jax.jit(lambda p, t: JM.prefill(
        p, {"tokens": t}, jcfg, max_len=MAX_LEN))(jp, jnp.asarray(tokens))
    toks = [np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))]
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    for _ in range(N_DECODE):
        logits, caches = decode(jp, caches, jnp.asarray(toks[-1]))
        toks.append(np.asarray(jnp.argmax(logits, -1).astype(jnp.int32)))
    params_np = jax.tree.map(np.asarray, jp)
    xs = {n: [np.random.default_rng(10 + r).standard_normal(
        (3, 50)).astype(np.float32) * (r + 1) for r in range(n)]
        for n in (2, 4)}
    # both widths' jobs at once: their ranks are single-threaded
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(
            spawn.run, ranks.collectives_and_parity, n,
            args=(xs[n], 32, params_np, cfg, tokens, MAX_LEN, N_DECODE),
            timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S) for n in (2, 4)}
        jobs = {n: f.result() for n, f in futures.items()}
    return {"tokens": np.stack(toks, 1), "logits": np.asarray(logits),
            "xs": xs, "jobs": jobs}


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_all_reduce_matches_reference(parity, n):
    """Every rank gets Σ_r dequantize(quantize(x_r)) of the reference's
    functions, in the input dtype."""
    def want(dtype):
        total = sum(np.asarray(jcoll.dequantize_int8(
            *jcoll.quantize_int8(jnp.asarray(x, dtype), 32), x.shape))
            for x in parity["xs"][n])
        return np.asarray(jnp.asarray(total, dtype), np.float32)

    for out in parity["jobs"][n]:
        np.testing.assert_allclose(out["f32"], want(jnp.float32), rtol=1e-6,
                                   atol=1e-6)
        assert out["bf16_dtype"] == "torch.bfloat16"
        # one bf16 ulp: the float32 sums may round to either neighbour
        np.testing.assert_allclose(out["bf16"], want(jnp.bfloat16),
                                   rtol=2 ** -7, atol=0)
    first = parity["jobs"][n][0]["f32"]
    for out in parity["jobs"][n][1:]:
        np.testing.assert_array_equal(out["f32"], first)


@pytest.mark.parametrize("n", [2, 4])
def test_manual_tp_tokens_equal_the_reference(parity, n):
    for out in parity["jobs"][n]:
        np.testing.assert_array_equal(out["tokens"], parity["tokens"])


@pytest.mark.parametrize("n", [2, 4])
def test_manual_tp_logits_within_1e_4(parity, n):
    for out in parity["jobs"][n]:
        err = np.max(np.abs(out["last_logits"] - parity["logits"]))
        assert err < 1e-4, err


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_seams_within_5e_2(parity, n):
    for out in parity["jobs"][n]:
        exact, comp = out["prefill_logits"], out["compressed_logits"]
        rel = np.max(np.abs(comp - exact)) / (np.max(np.abs(exact)) + 1e-9)
        assert 0 < rel < 5e-2, rel


# ========================================================= eligibility
@pytest.mark.parametrize("arch", sorted(jconfigs.arch_names()))
def test_tp_eligible_matches_reference(arch):
    for padded in (0, 24):
        jcfg = dataclasses.replace(jconfigs.get(arch), padded_heads=padded)
        tcfg = dataclasses.replace(tconfigs.get(arch), padded_heads=padded)
        for n in (1, 2, 4, 8):
            assert ttp.tp_eligible(tcfg, n) == jtp.tp_eligible(jcfg, n), \
                (arch, padded, n)


def test_tp_rules_match_reference():
    assert ttp.TP_RULES == jtp.TP_RULES
    assert ttp.TP_FAMILIES == jtp.TP_FAMILIES


def test_local_config_is_a_shard():
    cfg = tconfigs.get("qwen3-1.7b")
    local = ttp.local_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.hd) == \
        (8, 4, 3072, 128)
    with pytest.raises(ValueError, match="not divisible by 3"):
        ttp.local_config(cfg, 3)


# ================================================================= axes
@pytest.mark.parametrize("arch", sorted(jconfigs.arch_names()))
def test_param_and_cache_axes_match_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert _axes_leaves(TM.param_logical_axes(tcfg)) == \
        _axes_leaves(JM.param_logical_axes(jcfg))
    # cross K/V: a {'k', 'v'} dict here, a (k, v) tuple there
    assert [a for _, a in _axes_leaves(TM.cache_logical_axes(tcfg))] == \
        [a for _, a in _axes_leaves(JM.cache_logical_axes(jcfg))]


def test_serve_cache_axes_match_reference():
    """Against the reference's adaptation of its own slot caches."""
    jcfg, tcfg = jconfigs.get_smoke("qwen3-1.7b"), \
        tconfigs.get_smoke("qwen3-1.7b")
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    _, slot_axes = JM.alloc_slot_caches(
        jp, jcfg, 2, 32, {"tokens": np.zeros((1, 8), np.int32)})
    assert [a for _, a in _axes_leaves(TM.serve_cache_axes(tcfg))] == \
        [a for _, a in _axes_leaves(JM.serve_cache_axes(jcfg, slot_axes))]


@pytest.mark.parametrize("arch", sorted(jconfigs.arch_names()))
def test_serve_cache_axes_name_every_dim(arch):
    """One name per dim of every leaf of the port's serving caches,
    contiguous and (the attention families) paged."""
    cfg = tconfigs.get_smoke(arch)
    got = TM.serve_cache_axes(cfg)
    trees = [TM.alloc_slot_caches(cfg, 2, 32, device="cpu")]
    if cfg.family in TM.ATTENTION_FAMILIES and cfg.window is None:
        trees.append(TM.alloc_paged_caches(cfg, 2, 8, 9, device="cpu"))
    for caches in trees:
        for path, leaf in TM._leaves(caches):
            assert len(TM._at(got, path)) == leaf.dim(), path


def test_tp_shard_slices_the_model_dims():
    cfg = tconfigs.get_smoke("dbrx-132b")
    params = TM.init_lm(cfg, device="cpu")
    axes = TM.param_logical_axes(cfg)
    shards = [ttp.tp_shard(params, axes, r, 2) for r in range(2)]
    blk = params["blocks"]
    for name, dim in (("wq", 2), ("wk", 2), ("wo", 1)):
        got = torch.cat([s["blocks"]["attn"][name] for s in shards], dim)
        torch.testing.assert_close(got, blk["attn"][name], rtol=0, atol=0)
    for name, dim in (("w_gate", 3), ("w_down", 2)):
        got = torch.cat([s["blocks"]["ffn"][name] for s in shards], dim)
        torch.testing.assert_close(got, blk["ffn"][name], rtol=0, atol=0)
    assert shards[1]["blocks"]["ffn"]["router"] is blk["ffn"]["router"]
    assert shards[1]["embed"] is params["embed"]


# ============================================================ job and mesh
def test_mesh_axis_groups():
    """A (2, 2) mesh over 4 ranks: each axis's group sums the ranks along
    it; the production mesh refuses a 4-rank job."""
    outs = spawn.run(ranks.mesh_axes, 4, args=((2, 2), ("data", "model")),
                     timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S)
    for rank, out in enumerate(outs):
        d, m = divmod(rank, 2)
        assert out["coords"] == {"data": d, "model": m}
        assert out["sums"] == {"data": float(m + (m + 2)),
                               "model": float(2 * d + (2 * d + 1))}
        assert out["shape"] == {"data": 2, "model": 2}
        assert out["axis_names"] == ("data", "model")
        assert (out["backend"], out["device"], out["chips"]) == \
            ("gloo", "cpu", 4)
        assert "needs 256 ranks, the job has 4" in out["production"]
        assert out["host_shape"] == {"data": 4, "model": 1}
        assert out["broadcast"] == 100 + 2 * d


def test_a_failing_rank_fails_the_job():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        spawn.run(ranks.raises_on_rank_1, 2, timeout_s=TIMEOUT_S,
                  deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 60


def test_ranks_that_disagree_fail_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        spawn.run(ranks.desync, 2, timeout_s=3.0, deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 60


def test_the_deadline_ends_the_job():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn.run(ranks.sleeps, 2, args=(600.0,), timeout_s=TIMEOUT_S,
                  deadline_s=2.0)
    assert time.monotonic() - t0 < 60


def test_a_cuda_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA requested but not "
                                           "available"):
        spawn.rank_device(0, "cuda")
    assert spawn.backend_for("cpu", 2) == "gloo"
