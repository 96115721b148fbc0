"""The GSPMD serving path in the port: ``ContinuousEngine(mesh=)`` with
``tp_mode="gspmd"``, or "auto" on a config the manual path cannot shard,
over 2 and 4 ranks (gloo on loopback, one process a rank).

Each rank keeps only its ``NamedSharding.local`` blocks of the params and
caches under ``SERVE_RULES`` and gathers a layer at a time, so its greedy
tokens must be the one-device engine's exactly: on the reference's
``serve_sharded`` dense config (contiguous and paged, fifo and reversed
arrivals; also the JAX package's one-device ``ContinuousEngine`` on the
same weights), on the smoke variants of mamba2 (ssm), zamba2 (hybrid, with
a trailing block) and seamless (enc-dec, each request its own context), on
padded heads (both engines), and on a config whose 2 kv heads do not
divide 4 ranks (kept whole: the divisibility fallback; at 2 ranks "auto"
takes the manual path).  mamba2's and zamba2's runs split their SSM
mixers' heads (and zamba2's shared block) along ``"model"``; their
tokens are also the JAX package's one-device engine's, and one mamba2
layer's re-lays in a dispatch move no more than the columns and channels
its heads read, with no leaf gathered whole.  seamless's run splits its
encoder's, decoder's and cross-attention's heads and its MLPs at 2 ranks
(its 2 kv heads divide them; at 4 only its MLPs): each rank's self and
cross caches hold its heads, and a layer of it gathers nothing.  ``compressed_collectives``
is refused off the manual path, and a promotion staged on the first rank
(``--autotune`` on a mesh) swaps on every rank at the same step with
tokens unchanged.  One job per mesh width runs every case."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.cache import PendingPut  # noqa: E402
from repro_torch.core.registry import registry  # noqa: E402
from repro_torch.core.schedule import Schedule  # noqa: E402
from repro_torch.dist import partition, spawn, tp  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.serve import engine as tengine  # noqa: E402

#: the reference's ``serve_sharded`` config (tests/sharded_subprocess.py)
DENSE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=8,
             n_kv_heads=4, d_ff=256, vocab=128, dtype="float32")
#: its requests' (prompt length, budget): more than the 3 slots, so that
#: the arrival order changes the batching and splicing
SIZES = ((6, 5), (12, 4), (6, 6), (18, 3), (12, 5))
BOTH, CONTIGUOUS = ("contiguous", "paged"), ("contiguous",)
#: name -> (config, engines, tp_mode); the smoke variants' families
CASES = {
    "dense": (ModelConfig(**DENSE), BOTH, "gspmd"),
    "mamba2": (tconfigs.get_smoke("mamba2-2.7b"), CONTIGUOUS, "auto"),
    # 2 groups of 2 (the shared block on the second) and a trailing block
    "zamba2": (tconfigs.get_smoke("zamba2-7b", n_layers=5), CONTIGUOUS,
               "auto"),
    "seamless": (tconfigs.get_smoke("seamless-m4t-large-v2"), CONTIGUOUS,
                 "auto"),
    "padded": (tconfigs.get_smoke("qwen3-1.7b", padded_heads=8), BOTH,
               "auto"),
    # 4 heads and 2 kv heads: at 4 ranks the kv heads stay whole
    "kv_fallback": (tconfigs.get_smoke("qwen3-1.7b"), BOTH, "auto"),
}
ORDERS = ("fifo", "reversed")
#: the cases whose SSM mixers split their heads along "model"
SSM_NAMES = ("mamba2", "zamba2")
WIDTHS = (2, 4)
TIMEOUT_S, DEADLINE_S = 30.0, 240.0


def _scfg(engine: str, tp_mode: str = "auto") -> tengine.ServeConfig:
    paged = engine == "paged"
    return tengine.ServeConfig(max_len=48, capacity=3, paged=paged,
                               page_size=8,
                               prefill_chunk=8 if paged else None,
                               tp_mode=tp_mode)


def _runs(name: str) -> list[tuple[str, str]]:
    return [(e, o) for e in CASES[name][1] for o in ORDERS]


def _requests(cfg, seed: int):
    """The reference's request sizes; an enc-dec request carries its own
    standard-normal context."""
    rng = np.random.default_rng(seed)
    reqs = []
    for n, b in SIZES:
        extra = None
        if cfg.family == "enc_dec":
            extra = {"enc_embeds": rng.standard_normal(
                (cfg.enc_len, cfg.d_model)).astype(np.float32)}
        reqs.append((rng.integers(1, cfg.vocab, n).astype(np.int32), b,
                     extra))
    return reqs


def _serve_1dev(params, cfg, scfg, reqs, order):
    eng = tengine.ContinuousEngine(params, cfg, scfg,
                                   example_extra=reqs[0][2])
    idxs = list(range(len(reqs)))[::-1 if order == "reversed" else 1]
    uid_to_idx = {eng.submit(*reqs[i][:2], extra=reqs[i][2]).uid: i
                  for i in idxs}
    got = eng.run(max_steps=1000)
    return {i: got[u].tolist() for u, i in uid_to_idx.items()}


def _jax_engine(cfg, params_np, reqs):
    """The JAX package's one-device ContinuousEngine on a contiguous
    case's config and weights, its requests in order."""
    eng = jengine.ContinuousEngine(
        jax.tree.map(jnp.asarray, params_np),
        JConfig(**dataclasses.asdict(cfg)).validate(),
        jengine.ServeConfig(max_len=48, capacity=3))
    uids = [eng.submit(p, b).uid for p, b, _ in reqs]
    got = eng.run(max_steps=2000)
    return {i: np.asarray(got[u]).tolist() for i, u in enumerate(uids)}


# --------------------------------------------- the staged promotion (2 ranks)
SWAP_CFG = tconfigs.get_smoke("qwen3-1.7b", n_layers=2, n_heads=8,
                              n_kv_heads=4, head_dim=16)
SWAP_AT = 3


def _swap_put() -> PendingPut:
    """A legal non-default flash schedule at the signature a 2-rank manual
    path's prefill of a 16-token prompt resolves (its 4 heads and 2 kv
    heads): an autotune promotion for what that rank dispatches."""
    local = tp.local_config(SWAP_CFG, 2)
    name = fa_ops.ensure_registered(causal=True, window=None)
    s = fa_kernel.SEQ_TILE
    q = torch.zeros(1, local.n_heads, s, local.hd)
    kv = torch.zeros(1, local.n_kv_heads, s, local.hd)
    static = registry.spec(name).signature_fn(q, kv, kv)
    space = registry.spec(name).space_for(**static)
    knobs = {k.name: k.choices[-1] for k in space.knobs}
    assert knobs != space.default_knobs(), "the swap must change something"
    return PendingPut(kernel_name=name,
                      signature=registry.get(name).sig_str(static),
                      schedule=Schedule(knobs=knobs), energy=1e-9,
                      tests_passed=True, meta={"autotune": True})


@pytest.fixture(scope="module")
def served():
    """Per case: the requests and the one-device port engine's tokens per
    run (and the JAX engine's on the dense case); per mesh width, every
    rank's results per case and run; and the staged swap's, per rank."""
    cases, payload = {}, []
    for name, (cfg, _, tp_mode) in CASES.items():
        params_np = params_to_numpy(tm.init_lm(cfg, seed=3, device="cpu"))
        reqs = _requests(cfg, seed=len(payload))
        params = params_from_numpy(params_np, cfg, device="cpu")
        one = {(e, o): _serve_1dev(params, cfg, _scfg(e), reqs, o)
               for e, o in _runs(name)}
        cases[name] = {"cfg": cfg, "requests": reqs, "one_device": one}
        if name in ("dense",) + SSM_NAMES:
            cases[name]["jax"] = _jax_engine(cfg, params_np, reqs)
        payload.append({"cfg": cfg, "params": params_np, "requests": reqs,
                        "example_extra": reqs[0][2],
                        "runs": [(_scfg(e, tp_mode), o)
                                 for e, o in _runs(name)]})
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, SWAP_CFG.vocab, 16).astype(np.int32)
               for _ in range(4)]
    swap_params = params_to_numpy(tm.init_lm(SWAP_CFG, seed=5, device="cpu"))
    scfg = tengine.ServeConfig(max_len=32, capacity=2)
    want = _serve_1dev(params_from_numpy(swap_params, SWAP_CFG,
                                         device="cpu"), SWAP_CFG, scfg,
                       [(p, 6, None) for p in prompts], "fifo")
    swap = (SWAP_CFG, swap_params, prompts, [6] * len(prompts), scfg,
            [_swap_put()], SWAP_AT)
    # both widths' jobs at once: their ranks are single-threaded
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(spawn.run, ranks.serve_gspmd_runs, n,
                                  args=(payload, swap if n == 2 else None),
                                  timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S)
                   for n in WIDTHS}
        jobs = {n: f.result() for n, f in futures.items()}
    return cases, jobs, want


def _per_rank(served, name: str, n: int):
    """[rank][run] of case ``name`` at mesh width ``n``."""
    i = list(CASES).index(name)
    return [job["runs"][i] for job in served[1][n]]


def _path(name: str, n: int) -> str:
    """The path a case takes at width ``n``: 2 kv heads divide 2 ranks."""
    return "shard_map" if name == "kv_fallback" and n == 2 else "gspmd"


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name,engine,order", [
    (name, e, o) for name in CASES for e, o in _runs(name)])
def test_tokens_equal_the_one_device_engine(served, name, n, engine, order):
    want = served[0][name]["one_device"][engine, order]
    run = _runs(name).index((engine, order))
    for rank, runs in enumerate(_per_rank(served, name, n)):
        assert runs[run]["tokens"] == want, rank
        assert runs[run]["tp_path"] == _path(name, n)


@pytest.mark.parametrize("n", WIDTHS)
def test_dense_tokens_equal_the_jax_engine(served, n):
    """Every run of the reference's own config, at every width, gives the
    JAX package's one-device engine's tokens (its ``mesh{n}_gspmd``
    check, which cannot run on this tree)."""
    want = served[0]["dense"]["jax"]
    for runs in _per_rank(served, "dense", n):
        for run in runs:
            assert run["tokens"] == want


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", SSM_NAMES)
def test_ssm_tokens_equal_the_jax_engine(served, name, n):
    """Every run of mamba2's and zamba2's smoke configs, their mixers
    split by heads, gives the JAX package's one-device engine's tokens."""
    want = served[0][name]["jax"]
    for runs in _per_rank(served, name, n):
        for run in runs:
            assert run["tokens"] == want


def test_an_ssm_layer_gathers_only_what_its_heads_read():
    """mamba2's smoke config at depths 1 and 2 over 2 ranks: the second
    layer adds no all-gather to a prefill or a decode step (no leaf of it
    is gathered whole, the logits' gather is once a dispatch), and what it
    adds to the layout's gathered bytes (its re-lays' all-to-alls) is at
    most its rank's ``in_proj`` columns and conv channels (``B`` and ``C``
    in both) and, decoding, its conv state there and back: under its
    whole ``in_proj``."""
    base = tconfigs.get_smoke("mamba2-2.7b")
    cfgs = [dataclasses.replace(base, n_layers=k) for k in (1, 2)]
    rng = np.random.default_rng(2)
    rows, max_len = 2, 16
    tokens = rng.integers(0, base.vocab, (rows, 8)).astype(np.int32)
    got = spawn.run(ranks.layer_gathers, 2, args=(cfgs, tokens, max_len),
                    device="cpu", timeout_s=60.0, deadline_s=120.0)
    cols, chans = ssm.head_columns(base, 2)
    elt = 4                                  # float32 smoke weights
    d, w = base.d_model, base.conv_width
    whole_in_proj = d * ssm.mixer_shapes(base)["in_proj"][1] * elt
    for rank, (one, two) in enumerate(got):
        width = [sum(b - a for a, b in r[rank]) for r in (cols, chans)]
        weights = (d * width[0] + (w + 1) * width[1]) * elt
        state = 2 * rows * (w - 1) * width[1] * elt
        for step, bound in (("prefill", weights + state // 2),
                            ("decode", weights + state)):
            layer = two[step]["gathered"] - one[step]["gathered"]
            assert two[step]["collectives"]["all-gather"] == \
                one[step]["collectives"]["all-gather"], (rank, step)
            assert 0 < layer <= bound < whole_in_proj, (rank, step, layer)
            assert layer == two[step]["collectives"]["all-to-all"] \
                - one[step]["collectives"]["all-to-all"]


@pytest.mark.parametrize("n", WIDTHS)
def test_encdec_runs_its_heads_and_keeps_their_caches(served, n):
    """seamless at 2 ranks splits its attention (its 2 kv heads divide
    them) and MLPs: each rank's self and cross K/V hold one of the 2 kv
    heads; at 4 ranks only its MLPs are split and the K/V stay whole."""
    cfg = served[0]["seamless"]["cfg"]
    heads = cfg.n_kv_heads // n if n == 2 else cfg.n_kv_heads
    for runs in _per_rank(served, "seamless", n):
        for run in runs:
            assert run["split_cut"] == (["attn", "mlp"] if n == 2
                                        else ["mlp"])
            for leaf in ("self/k", "self/v", "cross/k", "cross/v"):
                shape = run["cache_shapes"][leaf]
                assert shape[-2:] == (heads, cfg.hd), (leaf, shape)
            assert run["cache_shapes"]["cross/k"][2] == cfg.enc_len


def test_an_encdec_layer_gathers_nothing():
    """seamless's smoke config at 1 + 1 and 2 + 2 layers over 2 ranks:
    the second encoder and decoder layers add nothing to what a prefill
    or a decode step gathers (the embedding's rows and the logits'
    columns, once a dispatch), and no all-to-all: no leaf of theirs and
    no cache is gathered.  The prefill's self and cross K/V are the
    rank's kv head."""
    base = tconfigs.get_smoke("seamless-m4t-large-v2")
    cfgs = [dataclasses.replace(base, enc_layers=k, dec_layers=k,
                                n_layers=2 * k) for k in (1, 2)]
    rng = np.random.default_rng(4)
    rows, max_len = 2, 16
    tokens = rng.integers(0, base.vocab, (rows, 8)).astype(np.int32)
    ctx = {"enc_embeds": rng.standard_normal(
        (rows, base.enc_len, base.d_model)).astype(np.float32)}
    got = spawn.run(ranks.layer_gathers, 2,
                    args=(cfgs, tokens, max_len, ctx), device="cpu",
                    timeout_s=60.0, deadline_s=120.0)
    for rank, (one, two) in enumerate(got):
        for step in ("prefill", "decode"):
            assert two[step]["gathered"] == one[step]["gathered"] > 0, \
                (rank, step)
            c1, c2 = one[step]["collectives"], two[step]["collectives"]
            assert c2["all-gather"] == c1["all-gather"], (rank, step)
            assert c2["all-to-all"] == 0
            assert c2["all-reduce"] > c1["all-reduce"]     # the seams
        for leaf in ("self/k", "cross/k"):
            assert two["cache_shapes"][leaf][-2] == base.n_kv_heads // 2


@pytest.mark.parametrize("name,n", [
    (name, n) for name in CASES for n in WIDTHS
    if _path(name, n) == "gspmd"])
def test_ranks_keep_only_their_blocks(served, name, n):
    """Every param leaf a rank keeps is its ``NamedSharding.local`` block
    of the whole model's, every cache leaf has its block's shape, some
    leaves are cut, and a rank keeps less than the whole model."""
    cfg = served[0][name]["cfg"]
    for runs in _per_rank(served, name, n):
        for run in runs:
            assert run["blocks_ok"]
            assert run["cut_leaves"] > 0
            assert run["param_share"] < 1.0
            assert run["gathered_bytes"] > 0
            want = "ok" if name == "dense" else tp.tp_eligible(cfg, n)[1]
            assert run["tp_reason"] == want


def test_kv_heads_that_do_not_divide_stay_whole():
    """At 4 ranks the 2 kv heads of the fallback case stay whole (its
    ``wk`` and K/V caches replicated) while its 4 heads are cut."""
    cfg = CASES["kv_fallback"][0]
    params = tm.init_lm(cfg, device="cpu")
    mesh = _mesh(4)
    eng = tengine.ContinuousEngine(params, cfg, _scfg("paged"), mesh=mesh)
    assert eng.tp_path == "gspmd"
    assert "n_kv_heads=2 not divisible by 4" in eng.tp_reason
    attn = eng.layout.params["blocks"]["attn"]
    assert attn["wk"].replicated and attn["wv"].replicated
    assert attn["wq"].spec == partition.PartitionSpec(None, None, "model",
                                                      None)
    assert eng.layout.caches["k"].replicated
    assert eng.params["blocks"]["attn"]["wq"].shape[2] == cfg.n_heads // 4
    assert eng.caches["k"].shape[-2] == cfg.n_kv_heads


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(served, name, n):
    per_rank = _per_rank(served, name, n)
    for runs in per_rank[1:]:
        assert [r["tokens"] for r in runs] == \
            [r["tokens"] for r in per_rank[0]]


# ======================================================== mesh-free checks
def _mesh(n: int = 2) -> Mesh:
    """A rank's mesh view without a process group: enough to build an
    engine, which runs no collective before its first dispatch."""
    return Mesh(shape={"model": n}, rank=0, device=torch.device("cpu"),
                backend="gloo", groups={"model": None}, coords={"model": 0})


@pytest.mark.parametrize("arch,over,tp_mode", [
    ("mamba2-2.7b", {}, "auto"), ("qwen3-1.7b", {}, "gspmd")])
def test_compressed_collectives_need_the_manual_path(arch, over, tp_mode):
    cfg = tconfigs.get_smoke(arch, **over)
    with pytest.raises(ValueError, match="compressed_collectives needs the "
                                         "shard_map TP path"):
        tengine.ContinuousEngine(
            tm.init_lm(cfg, device="cpu"), cfg, tengine.ServeConfig(
                max_len=32, capacity=2, tp_mode=tp_mode,
                compressed_collectives=True), mesh=_mesh())


def test_caches_are_allocated_as_blocks():
    """The engine allocates only its blocks: mamba2's SSD and conv states
    hold half of their heads and channels at 2 ranks."""
    cfg = tconfigs.get_smoke("mamba2-2.7b")
    eng = tengine.ContinuousEngine(tm.init_lm(cfg, device="cpu"), cfg,
                                   tengine.ServeConfig(max_len=32,
                                                       capacity=2),
                                   mesh=_mesh())
    whole = tm.alloc_slot_caches(cfg, 2, 32, device="meta")
    assert eng.caches["ssd"].shape[2] == whole["ssd"].shape[2] // 2
    assert eng.caches["conv"].shape[-1] == whole["conv"].shape[-1] // 2
    assert eng.caches["ssd"].device.type == "cpu"


def test_hooks_are_the_identity_off_a_mesh():
    """Outside a materialising scope the layer hooks hand back what they
    are given, and ``write_back`` is a plain copy."""
    t = torch.arange(6.0).reshape(2, 3)
    assert partition.whole(t, "embed") is t
    assert partition.whole_cache({"k": t})["k"] is t
    ids = torch.tensor([1, 0])
    assert torch.equal(partition.take(t, ids, "embed"), t[ids])
    dst = {"k": torch.zeros(2, 3)}
    partition.write_back(dst, {"k": t})
    assert torch.equal(dst["k"], t)


# ===================================================== a staged promotion
def test_staged_promotion_swaps_every_rank_at_the_same_step(served):
    """The first rank stages a promotion before step boundary 3; both
    ranks apply it there and swap before the same dispatch, resolve the
    promoted schedule, and their tokens are the one-device engine's."""
    want = served[2]
    swaps = [job["swap"] for job in served[1][2]]
    put = _swap_put()
    for s in swaps:
        assert s["tp_path"] == "shard_map"
        assert s["swaps"] == 1 and s["version"] == 1
        assert s["resolved"] == [dict(put.schedule.knobs)]
        assert [s["tokens"][i] for i in sorted(s["tokens"])] == \
            [want[i] for i in sorted(want)]
    assert swaps[0]["swap_steps"] == swaps[1]["swap_steps"] == [SWAP_AT - 1]


def test_staging_holds_writes_until_taken():
    from repro_torch.autotune import Staging, apply_staged
    from repro_torch.core.cache import ScheduleCache
    put = dataclasses.replace(_swap_put(), kernel_name="k", signature="s")
    staging = Staging()
    staging.commit([put])
    staging.drop("k", "s")
    staging.commit([put])
    assert staging.pending("k", "s") == 2
    store = ScheduleCache()
    ops = staging.take()
    assert staging.take() == [] and store.version == 0
    apply_staged(store, ops)
    assert store.version == 3 and len(store.entries("k", "s")) == 1
