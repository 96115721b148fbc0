"""The port's SIP core against the JAX package's: the five kernels'
programs at every knob point of their smoke and deploy spaces, ``emit``,
the annealers' trajectories under the v5e cost model, probabilistic testing
with a fault injector, and the schedule cache's JSON read across packages.
Trajectories are compared exactly (best_raw to rel 1e-12)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import core as jcore  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.core.registry import registry as jregistry  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core.energy import UnassemblableSchedule  # noqa: E402
from repro_torch.core.ir import Instr, Kind, Program  # noqa: E402
from repro_torch.core.registry import registry as tregistry  # noqa: E402
from repro_torch.kernels import _emit  # noqa: E402
from repro_torch.kernels.gemm_fused import kernel as tgemm  # noqa: E402

jkernels.load_all()
tkernels.load_all()

KERNELS = ("flash_attention_causal", "gemm_fused_leaky_relu", "paged_gather",
           "rmsnorm_fused", "ssd_intra_chunk")
CASES = [(k, w.name) for k in KERNELS
         for w in jregistry.spec(k).workloads]


def _static(name, workload):
    spec = jregistry.spec(name)
    wl = next(w for w in spec.workloads if w.name == workload)
    return spec.signature_fn(*wl.make_args(np.random.default_rng(0)))


def _fields(prog):
    return ([(i.name, i.kind.value, i.inputs, i.outputs, i.buffer,
              i.is_store, i.bytes, i.flops) for i in prog.instrs],
            prog.replications, [sorted(d) for d in prog.deps])


@pytest.mark.parametrize("name,workload", CASES)
def test_programs_equal_reference_at_every_knob_point(name, workload):
    static = _static(name, workload)
    jspec, tspec = jregistry.spec(name), tregistry.spec(name)
    jspace, tspace = jspec.space_for(**static), tspec.space_for(**static)
    assert [(k.name, k.choices) for k in jspace.knobs] == \
        [(k.name, k.choices) for k in tspace.knobs]
    names = [k.name for k in jspace.knobs]
    points = list(itertools.product(*[k.choices for k in jspace.knobs]))
    for point in points:
        knobs = dict(zip(names, point))
        jprog = jspec.program_for(jcore.Schedule(knobs=knobs), **static)
        tprog = tspec.program_for(tcore.Schedule(knobs=knobs), **static)
        assert _fields(tprog) == _fields(jprog), knobs
        assert all(i.src or i.kind is Kind.COMPUTE for i in tprog.instrs)


@pytest.mark.parametrize("name,workload", CASES)
def test_signatures_equal_reference(name, workload):
    spec = jregistry.spec(name)
    wl = next(w for w in spec.workloads if w.name == workload)
    args = wl.make_args(np.random.default_rng(0))
    tensors = [torch.from_numpy(a) for a in args]
    assert tregistry.spec(name).signature_fn(*tensors) == \
        spec.signature_fn(*args)


def _toy():
    def fn(env):
        return {}
    return Program([
        Instr("ld_a", Kind.MEM, (), ("a",), fn, buffer="a", src="LA;"),
        Instr("ld_b", Kind.MEM, (), ("b",), fn, buffer="b", src="LB;"),
        Instr("add", Kind.COMPUTE, ("a", "b"), ("c",), fn, src="ADD;"),
        Instr("st_c", Kind.MEM, ("c",), (), fn, buffer="o", is_store=True,
              src="ST;")])


def test_emit_lays_snippets_out_in_order_and_rejects_illegal_orders():
    prog = _toy()
    text = prog.emit((1, 0, 2, 3))
    assert [ln for ln in text.splitlines() if not ln.startswith("//")] == \
        ["LB;", "LA;", "ADD;", "ST;"]
    assert prog.emit().index("LA;") < prog.emit().index("LB;")
    hooked = prog.emit(before=lambda ins: f"/*{ins.name}*/")
    assert hooked.index("/*add*/") < hooked.index("ADD;")
    for bad in [(0, 2, 1, 3), (0, 1, 3, 2), (0, 1, 2)]:
        with pytest.raises(ValueError, match="illegal"):
            prog.emit(bad)


def test_hoisted_order_needs_more_shared_memory_and_is_rejected_past_227kb():
    kw = dict(m=512, n=512, k=2048, bm=128, bn=128, bk=128, dtype="bfloat16")
    default = tgemm.GemmKernel(**kw)
    text, smem = default.source()
    assert smem <= 232_448 and text.count("__syncthreads();") == 31
    prog = default.program
    # hoist ld_x1 and ld_w1 above dot0: step 0 and step 1 tiles live at once
    order = list(prog.default_order())
    order.remove(4)
    order.remove(5)
    order[3:3] = [4, 5]
    assert prog.is_legal(order)
    _, smem2 = tgemm.GemmKernel(**kw, order=order).source()
    assert smem2 > smem
    # hoist every load of steps 0..3 ahead of dot0
    order = [0] + [i for s in range(4) for i in (1 + 3 * s, 2 + 3 * s)]
    order += [i for i in prog.default_order() if i not in order]
    assert prog.is_legal(order)
    with pytest.raises(UnassemblableSchedule, match="232448"):
        tgemm.GemmKernel(**kw, order=order).source()


def replay_async_groups(program, text):
    """Replay the cp.async group queue of an emitted body: each MEM load's
    ``cp_async_commit();`` pushes a group holding the buffers it fills
    (buffer = value name upper-cased), ``cp_async_wait<N>();`` completes all
    but the newest N groups, and every instruction that reads a loaded
    buffer must find its group complete.  Also checks that each load's
    snippet ends in exactly one commit outside any condition.  Returns the
    number of reads checked."""
    by_name = {ins.name: ins for ins in program.instrs}
    loads = [ins for ins in program.instrs
             if ins.kind is Kind.MEM and not ins.is_store]
    for ins in loads:
        stmts = [st.strip() for st in ins.src.split(";") if st.strip()]
        assert stmts[-1] == "cp_async_commit()", ins.src
        assert ins.src.count("cp_async_commit();") == 1 and "{" not in ins.src
    groups, done, group_of, reads, current = [], 0, {}, 0, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("// ") and line[3:] in by_name:
            current = by_name[line[3:]]
            for v in current.inputs:
                if v.upper() in group_of:
                    assert group_of[v.upper()] < done, (current.name, v)
                    reads += 1
        elif line.startswith("cp_async_wait<"):
            done = max(done, len(groups) - int(line[14:line.index(">")]))
        elif "cp_async_commit();" in line:
            for v in current.outputs:
                group_of[v.upper()] = len(groups)
            groups.append(current.name)
    assert sorted(groups) == sorted(ins.name for ins in loads)
    return reads


#: declarations that let a host C++ compiler parse an emitted CUDA text
HOST_STUBS = """
#include <cstddef>
#include <cmath>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __align__(x)
#define __shared__
struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx, blockIdx, gridDim, blockDim;
void __syncthreads();
template <typename V> V __shfl_xor_sync(unsigned, V, int);
template <typename V> V __shfl_up_sync(unsigned, V, int);
float __uint_as_float(unsigned);
unsigned __float_as_uint(float);
double __longlong_as_double(long long);
size_t __cvta_generic_to_shared(const void*);
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
float2 make_float2(float, float);
float4 make_float4(float, float, float, float);
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
template <typename V> V __ldg(const V*);
float rsqrtf(float);
float expf(float);
int min(int, int);
int max(int, int);
using std::exp; using std::fabs; using std::fmaf;
"""


def host_syntax_errors(text: str, workdir) -> str:
    """A host compiler's errors on ``text`` behind :data:`HOST_STUBS` (""
    when it parses): wrong names, arities, types and macro clashes show
    here; what only nvcc and ptxas check (PTX, registers) does not."""
    import subprocess
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".cpp", dir=workdir,
                                     delete=False) as f:
        f.write(HOST_STUBS + text)
    done = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w",
                           f.name], capture_output=True, text=True)
    return done.stderr if done.returncode else ""


def _syntax_texts(name):
    """The texts of ``name`` to check: the default and seeded orders at
    each registry workload, and this kernel's main-path shapes (RMSNorm at
    every knob point of the model's and the smoke widths, the SSD at every
    chunk the model's path uses and 16 orders each)."""
    spec = tregistry.spec(name)
    kerns = []
    for w in spec.workloads:
        static = _static(name, w.name)
        prog = spec.program_for(tcore.Schedule(), **static)
        for seed in (None, 0, 1, 2, 3):
            order = None if seed is None \
                else _emit.random_legal_order(prog, seed)
            kerns.append(spec.build(tcore.Schedule(order=order), **static))
    if name == "rmsnorm_fused":
        for (rows, d), dtype in itertools.product(
                [(4096, 2560), (16, 32), (64, 128)], ("float32", "bfloat16")):
            static = {"rows": rows, "d": d, "dtype": dtype}
            space = spec.space_for(**static)
            for point in itertools.product(*[k.choices for k in space.knobs]):
                knobs = dict(zip([k.name for k in space.knobs], point))
                kerns.append(spec.build(tcore.Schedule(knobs=knobs), **static))
    if name == "ssd_intra_chunk":
        from repro_torch.kernels.ssd import kernel as tssd
        for q in (8, 16, 64, 256):
            prog = tssd.make_program(q=q, n=128, p=64)
            for seed in [None] + list(range(16)):
                order = None if seed is None \
                    else _emit.random_legal_order(prog, seed)
                kerns.append(tssd.SsdKernel(q=q, n=128, p=64, order=order))
            kerns.append(tssd.SsdKernel(q=q, n=128, p=64, dtype="bfloat16"))
    texts = set()
    for kern in kerns:
        try:
            texts.add(kern.source()[0])
        except UnassemblableSchedule:
            pass
    return sorted(texts)


@pytest.mark.parametrize("name", KERNELS)
def test_emitted_texts_pass_a_host_syntax_check(name, tmp_path):
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    texts = _syntax_texts(name)
    assert texts
    with ThreadPoolExecutor(4) as pool:
        errors = [e for e in pool.map(
            lambda t: host_syntax_errors(t, tmp_path), texts) if e]
    assert not errors, errors[0][:2000]


def check_schedules(name, static, seed, replay=True):
    """At every knob point of ``name``'s space at ``static`` and the default
    (seed None) or a seeded random legal order: the schedule assembles
    within a block's shared memory or raises UnassemblableSchedule, and an
    assembled one waits for every group before reading it."""
    spec = tregistry.spec(name)
    space = spec.space_for(**static)
    names = [k.name for k in space.knobs]
    built = rejected = 0
    for point in itertools.product(*[k.choices for k in space.knobs]):
        knobs = dict(zip(names, point))
        prog = spec.program_for(tcore.Schedule(knobs=knobs), **static)
        order = None if seed is None else _emit.random_legal_order(prog, seed)
        kern = spec.build(tcore.Schedule(knobs=knobs, order=order), **static)
        try:
            text, smem = kern.source()
        except UnassemblableSchedule:
            rejected += 1
            continue
        assert smem <= 232_448
        if replay:
            assert replay_async_groups(kern.program, text) > 0, knobs
        built += 1
    return built, rejected


@pytest.mark.parametrize("seed", [None, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("static", [
    dict(m=512, n=512, k=2048, dtype="bfloat16"),
    dict(m=16, n=16, k=32, dtype="bfloat16"),
    dict(m=16, n=16, k=32, dtype="float32")],
    ids=["paper_bf16", "smoke_bf16", "smoke_f32"])
def test_gemm_schedules_assemble_or_reject_and_wait_for_their_groups(static,
                                                                     seed):
    built, rejected = check_schedules("gemm_fused_leaky_relu", static, seed)
    assert built > 0
    if static["m"] == 512:
        assert rejected > 0       # bm = bn = 512 cannot hold its accumulator


def test_gemm_default_assembles_at_every_workload_and_the_paper_shape():
    spec = tregistry.spec("gemm_fused_leaky_relu")
    statics = [_static("gemm_fused_leaky_relu", w.name)
               for w in spec.workloads]
    statics.append(dict(m=512, n=512, k=2048, dtype="bfloat16"))
    for static in statics:
        for dtype in ("float32", "bfloat16"):
            kern = spec.build(tcore.Schedule(), **{**static, "dtype": dtype})
            assert kern.source()[1] <= 232_448, static


def test_gemm_tile_too_large_for_its_registers_is_rejected_and_counted():
    from repro_torch.kernels import _build
    before = _build.STATS.reg_rejections
    for dtype in ("bfloat16", "float32"):
        with pytest.raises(UnassemblableSchedule, match="registers"):
            tgemm.GemmKernel(m=512, n=512, k=2048, bm=512, bn=512, bk=64,
                             dtype=dtype).source()
    assert _build.STATS.reg_rejections == before + 2


def test_bf16_gemm_pads_small_tiles_and_fences_wgmma_reads():
    kern = tgemm.GemmKernel(m=16, n=16, k=32, bm=8, bn=8, bk=8,
                            dtype="bfloat16")
    text, smem = kern.source()
    lay = kern.layout
    # 8 rows and 8 k zero-filled to the instruction's 64 x 16: per step one
    # 64 x 16 X tile and one 16 x 8 W tile
    assert (lay["MP"], lay["KP"], lay["BNW"], lay["NT"]) == (64, 16, 8, 128)
    assert smem == 64 * 16 * 2 + 16 * 8 * 2
    body = text[text.index("// init_acc"):]
    assert body.count("fence_proxy_async();") == 4    # one per dot
    assert body.index("fence_proxy_async();") < body.index("// dot0")


def test_random_legal_orders_are_legal_and_seeded():
    prog = tregistry.spec("flash_attention_causal").program_for(
        tcore.Schedule(), **_static("flash_attention_causal",
                                    "smoke_b1_h2kv2_s16_d8"))
    orders = [_emit.random_legal_order(prog, s) for s in range(5)]
    assert all(prog.is_legal(o) for o in orders)
    assert orders == [_emit.random_legal_order(prog, s) for s in range(5)]
    assert len(set(orders)) > 1


def _search(pkg, name, static, chains, seed):
    reg = jregistry if pkg is jcore else tregistry
    spec = reg.spec(name)
    space = spec.space_for(**static)

    def program_for(s):
        return spec.program_for(s, **static)
    x0 = pkg.Schedule(knobs=space.default_knobs())
    energy = pkg.CostModelEnergy(program_for)
    policy = pkg.MutationPolicy(space=space, program_for=program_for)
    if chains == 0:
        res = pkg.anneal(x0, energy, policy.propose, cooling=1.1, seed=seed)
        return res.best.signature(), res.evals, res.best_raw
    pop = pkg.population_anneal(x0, energy, policy.propose, chains=chains,
                                cooling=1.1, exchange_every=4, seed=seed)
    return pop.best.signature(), pop.evals, pop.best_raw, pop.exchanges


@pytest.mark.parametrize("chains", [0, 1, 4])
@pytest.mark.parametrize("name,workload", [
    ("flash_attention_causal", "deploy_b1_h4kv2_s128_d32"),
    ("gemm_fused_leaky_relu", "deploy_64x64x128"),
    ("paged_gather", "deploy_p64_ps16_h4_d32_b8_n8"),
    ("rmsnorm_fused", "deploy_64x128"),
    ("ssd_intra_chunk", "deploy_g4_q16_h4_p8_n16")])
def test_annealers_follow_the_reference_trajectory(name, workload, chains):
    static = _static(name, workload)
    got = _search(tcore, name, static, chains, seed=3)
    want = _search(jcore, name, static, chains, seed=3)
    assert got[0] == want[0] and got[1] == want[1] and got[3:] == want[3:]
    assert got[2] == pytest.approx(want[2], rel=1e-12)


def test_probabilistic_test_with_fault_injector_matches_reference():
    for threshold, batch in [(2.6, 16), (3.2, 4), (99.0, 8)]:
        reports = []
        for mod in (jcore.testing, tcore.testing):
            cand = mod.FaultInjector(fn=lambda x: x * 2.0, threshold=threshold)
            specs = [mod.InputSpec((16,), np.float32)]
            reports.append(mod.probabilistic_test(
                cand, lambda x: x * 2.0, specs, 40,
                np.random.default_rng(7), batch=batch))
        j, t = reports
        assert (t.passed, t.samples_run, t.first_failure) == \
            (j.passed, j.samples_run, j.first_failure)
        assert t.max_err == pytest.approx(j.max_err, rel=1e-6)
    assert not reports[0].passed or threshold == 99.0


def test_schedule_cache_json_reads_across_packages(tmp_path):
    sched = {"knobs": {"bm": 16, "bn": 16, "bk": 32}, "order": [0, 2, 1, 3]}
    for writer, reader in ((jcore, tcore), (tcore, jcore)):
        path = str(tmp_path / f"{writer.__name__}.json")
        w = writer.ScheduleCache(path)
        w.put("gemm_fused_leaky_relu", '{"m": 16}',
              writer.Schedule(knobs=sched["knobs"],
                              order=tuple(sched["order"])),
              energy=1.5e-7, tests_passed=True, test_samples=4, round_id=0,
              evals=6)
        w.put("gemm_fused_leaky_relu", '{"m": 16}', writer.Schedule(),
              energy=1e-7, tests_passed=False)
        r = reader.ScheduleCache(path)
        best = r.best("gemm_fused_leaky_relu", '{"m": 16}')
        assert dict(best.knobs) == sched["knobs"]
        assert list(best.order) == sched["order"]
        assert [e.to_dict() for e in r.entries("gemm_fused_leaky_relu",
                                               '{"m": 16}')] == \
            [e.to_dict() for e in w.entries("gemm_fused_leaky_relu",
                                            '{"m": 16}')]


def test_wallclock_energy_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    energy = tcore.WallClockEnergy(build=lambda s: None, make_args=list)
    with pytest.raises(RuntimeError, match="CUDA"):
        energy(tcore.Schedule())
