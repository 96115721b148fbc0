"""Multi-pod dry run of the port: count what every (arch x shape x mesh)
cell needs per device, without a device (the port of
``repro/launch/dryrun.py``).

For each cell this starts a fake world of 256 (16x16, one pod) or 512
(2x16x16, two pods) ranks as rank 0 (torch's ``"fake"`` process-group
backend: collectives return at once and move nothing), builds the
production mesh over it with ``launch/mesh.make_production_mesh``, makes
the step's arguments as fake tensors (``FakeTensorMode``) at each leaf's
local shape, and runs the port's own step on them: ``steps.sharded_train_step``
(train), ``steps.prefill_step`` or ``steps.serve_step``, at full depth.
Nothing is allocated and no kernel is launched (``use_pallas`` stays off,
as in the reference's dry run).  The fake tensors lie on ``"cuda"``, so
the step takes the card's branches inside torch, wherever torch is built
with CUDA (no card is needed); a torch built for the CPU alone has no
CUDA device guard, on which autograd aborts the process, so there they
lie on ``"cpu"`` (:func:`fake_device`; the record's ``fake_device``).
The counts do not depend on it: FLOPs come from shapes, memory is
rounded to the CUDA allocator's blocks either way.

Where the reference reads XLA's cost analysis and parses collectives out
of the optimized HLO (``parse_collectives``), the port has no HLO:
:class:`StepCounter`, one ``TorchDispatchMode``, sees every aten op and
every ``c10d`` collective the step dispatches and counts

* FLOPs, with ``torch.utils.flop_counter``'s formulas;
* bytes: each aten op's input plus output bytes (views and metadata
  queries excepted; a broadcast dimension once), the eager program's
  traffic, which has no fusion (``hlo_bytes_per_device``);
* peak memory: the bytes of every live storage, the step's arguments
  included, each rounded up to the CUDA caching allocator's 512-byte
  block;
* collectives: each one's result bytes with the reference's weights
  (:data:`COLLECTIVE_WEIGHT`), by op and by mesh axis.

The same mode counts a real run (real tensors, a real process group),
which is how the dry run is held to the truth (``tests/test_torch_dryrun
_ranks.py``, ``chip_smoke.py``'s ``dryrun_vs_card``).  Eager code counts
every layer, so the costs come from the full-depth step; the reference's
depth-1 and depth-2 probes still run and their linear extrapolation is
recorded under ``probe``.  Roofline terms use ``costmodel.H100`` (the
H100 SXM 80GB's data-sheet rates at 700 W).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_results_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.core import costmodel
from repro_torch.dist import partition
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# bytes-on-the-wire weights per op (result-shape based; all-reduce counts 2x
# for its reduce-scatter + all-gather phases)
COLLECTIVE_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}
#: each ``c10d`` op's collective; its first argument holds the result
#: tensors (a receive's for a point-to-point pair)
C10D_OPS = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
            "allgather_coalesced_": "all-gather",
            "allgather_into_tensor_coalesced_": "all-gather",
            "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
            "reduce_scatter_": "reduce-scatter",
            "_reduce_scatter_base_": "reduce-scatter",
            "reduce_scatter_tensor_coalesced_": "reduce-scatter",
            "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
            "recv_": "collective-permute",
            "recv_any_source_": "collective-permute"}
#: ``c10d`` ops with no result bytes at this rank
C10D_SILENT = ("barrier", "monitored_barrier_", "send")
#: the CUDA caching allocator's block: every allocation is rounded up to it
ALLOC_BLOCK = 512


# ================================================================ counting
def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in ``tree`` that hold data: a ``meta`` tensor is a
    shape record (``steps.param_sds``), which holds and moves nothing."""
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type != "meta"]


def _touched(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements, a broadcast
    (stride-0) dimension's once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


def _axes_of(mesh) -> dict[str, str]:
    """Each of ``mesh``'s axis groups by name -> its axis."""
    if mesh is None:
        return {}
    return {mesh.group(a).group_name: a for a in mesh.shape
            if mesh.shape[a] > 1}


class StepCounter(TorchDispatchMode):
    """Counts what the ops dispatched under it do (see the module
    docstring): ``flops``, ``bytes``, ``peak_bytes`` (and ``live_bytes``),
    ``collectives`` (weighted result bytes by op) and ``by_axis`` (axis ->
    op -> weighted bytes; a group of no axis of ``mesh`` counts under
    ``"other"``).  Storages that exist before the step (its arguments) are
    counted once :meth:`hold` is given them.  Works alike on fake and real
    tensors; enter it inside a ``FakeTensorMode``."""

    def __init__(self, mesh=None):
        super().__init__()
        self.axes = _axes_of(mesh)
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVE_OPS, 0.0)
        self.by_axis: dict[str, dict[str, float]] = {}
        self._live: dict[int, Any] = {}

    # ------------------------------------------------------------ memory
    def _track(self, st) -> None:
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        key = id(st)

        def freed(_, key=key, n=n):
            self._live.pop(key, None)
            self.live_bytes -= n

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def hold(self, *trees) -> "StepCounter":
        """Count the storages of every tensor in ``trees`` as live."""
        for t in _tensors(trees):
            st = t.untyped_storage()
            if id(st) not in self._live:
                self._track(st)
        return self

    # ----------------------------------------------------------- dispatch
    def _collective(self, func, args) -> None:
        name = func._opname
        if name in C10D_SILENT:
            return
        if name not in C10D_OPS:
            raise NotImplementedError(f"{func}: no collective weight for it")
        op = C10D_OPS[name]
        result = sum(t.nbytes for t in _tensors(args[0]))
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        axis = self.axes.get(dist.ProcessGroup.unbox(group).group_name,
                             "other")
        w = COLLECTIVE_WEIGHT[op] * result
        self.collectives[op] += w
        per = self.by_axis.setdefault(axis, dict.fromkeys(COLLECTIVE_OPS,
                                                          0.0))
        per[op] += w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        # metadata queries (``prim.device`` on a fake tensor, sizes) and
        # views move nothing
        if func.namespace == "aten" and outs and not func.is_view:
            ins = _tensors((args, kwargs))
            self.bytes += sum(map(_touched, ins)) + sum(map(_touched, outs))
            fresh = [st for st in (t.untyped_storage() for t in outs)
                     if id(st) not in self._live]
            if fresh:
                seen = {id(t.untyped_storage()) for t in ins}
                for st in fresh:
                    if id(st) not in seen and id(st) not in self._live:
                        self._track(st)
        return out

    def result(self) -> dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = sum(coll[op] for op in COLLECTIVE_OPS)
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes, "collective_bytes": coll,
                "collective_bytes_by_axis": {a: dict(v) for a, v in
                                             sorted(self.by_axis.items())}}


def count(step, args, mesh=None) -> dict[str, Any]:
    """Run ``step()`` under a :class:`StepCounter` whose live storages start
    as ``args``'s -> its :meth:`~StepCounter.result` and ``held_bytes``,
    the arguments' own.  The cycle collector runs just before the step and
    is off during it, so a storage caught in a reference cycle is freed at
    the same moment on every run (at the step's end), and the peak is the
    same number from run to run, fake or real.  ``torch._dynamo`` is
    imported first: torch imports it at the first call of a collective,
    and that import leaves a reference cycle holding the caller's frame
    (its tensors) behind."""
    import torch._dynamo  # noqa: F401
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        counter = StepCounter(mesh).hold(args)
        held = counter.live_bytes
        with counter:
            step()
    finally:
        if was:
            gc.enable()
    return {**counter.result(), "held_bytes": held}


# ============================================================ fake worlds
@contextlib.contextmanager
def fake_world(ranks: int) -> Iterator[None]:
    """This process as rank 0 of a fake world of ``ranks`` ranks (torch's
    ``"fake"`` backend), destroyed on the way out.  Refuses to start while
    a process group is initialized: the dry run never joins a real job,
    and leaves none behind to poison a later one."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world, and a "
                           "process group is already initialized here")
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_device() -> str:
    """``"cuda"`` where torch is built with CUDA, else ``"cpu"`` (see the
    module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """``mesh_lib.mesh_for`` over the fake world, its tensors on
    :func:`fake_device`."""
    mesh = mesh_lib.mesh_for(shape, axes)
    mesh.device = torch.device(fake_device())
    return mesh


# ================================================================== cells
def bytes_per_device(sds_tree, shardings) -> float:
    """Analytic per-device bytes of a (shape record, NamedSharding) tree."""
    recs, shs = flatten(sds_tree), flatten(shardings)
    return float(sum(math.prod(shs[k].local_shape) * v.element_size()
                     for k, v in recs.items()))


def count_params(shapes_tree, cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the shape tree
    (``M.param_shapes``)."""
    total = active = 0
    for path, shape in flatten(shapes_tree).items():
        n = math.prod(shape)
        total += n
        keys = path.split("/")
        is_expert = cfg.family == "moe" and "ffn" in keys \
            and "router" not in keys
        active += int(n * cfg.top_k / cfg.n_experts) if is_expert else n
    return total, active


def model_flops(cfg, shape, total_params: int, active_params: int) -> float:
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    n = active_params
    per_token = 6 * n if shape.kind == "train" else 2 * n
    return float(per_token) * tokens


def _zeros(tree, device):
    return M.map_params(lambda _, r: torch.zeros(r.shape, dtype=r.dtype,
                                                 device=device), tree)


def build_cell(cfg, shape, mesh, *, max_len: int | None = None):
    """-> (step, args, extra): the cell's step as a closure over ``args``,
    its arguments as this rank of ``mesh`` holds them (zeros at each leaf's
    local shape on ``mesh.device``; fake tensors under a
    ``FakeTensorMode``), and the reference's extra record keys.  Train:
    float32 master params and moments, the global batch with its loss
    mask; prefill: the params as serving keeps them and the global prompt
    batch, caches of ``max_len`` (default ``shape.seq_len``); decode: those
    params, the rank's blocks of zero caches of ``shape.seq_len`` and the
    global tokens.  The serving steps build their own layout
    (``steps.serve_layout``, their default), the one these arguments are
    cut by."""
    dev = mesh.device
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        pshard = steps.param_shardings(cfg, mesh)
        params = partition.blocks_zeros(steps.param_sds(cfg), pshard, dev)
        opt = adamw.init_opt_state(params)
        batch = _zeros(steps.batch_sds(cfg, shape), dev)
        # the port's training batches carry a float32 loss mask
        # (data/pipeline.batch_for_model), whose token counts the data
        # ranks all-reduce
        batch["mask"] = torch.ones((b, s), dtype=torch.float32, device=dev)
        nmb = cfg.force_microbatches or steps.pick_microbatches(cfg, shape,
                                                                mesh)

        def train():
            return steps.sharded_train_step(
                params, opt, batch, cfg=cfg, opt_cfg=adamw.OptConfig(),
                mesh=mesh, shardings=pshard, num_microbatches=nmb)
        return train, (params, opt, batch), {"num_microbatches": nmb}

    if shape.kind == "prefill":
        max_len = max_len or s
        rows = steps.serve_rows(cfg, mesh, b, s).local_shape[0]
        layout = steps.serve_layout(cfg, mesh, rows, max_len)
        params = partition.blocks_zeros(steps.serve_param_sds(cfg),
                                        layout.params, dev)
        batch = _zeros(steps.batch_sds(cfg, shape, with_labels=False), dev)

        def prefill():
            return steps.prefill_step(params, batch, cfg=cfg,
                                      max_len=max_len, mesh=mesh)
        return prefill, (params, batch), {}

    if shape.kind == "decode":
        rows = steps.serve_rows(cfg, mesh, b, 1,
                                dropless=True).local_shape[0]
        layout = steps.serve_layout(cfg, mesh, rows, s)
        params = partition.blocks_zeros(steps.serve_param_sds(cfg),
                                        layout.params, dev)
        caches = partition.blocks_zeros(steps.cache_sds(cfg, rows, s),
                                        layout.caches, dev)
        tokens = torch.zeros((b,), dtype=torch.int32, device=dev)

        def decode():
            return steps.serve_step(params, caches, tokens, cfg=cfg,
                                    mesh=mesh)
        return decode, (params, caches, tokens), {}

    raise ValueError(shape.kind)


def probe_cfg(cfg, units: int):
    """A ``units``-deep variant of ``cfg`` for cost probing, plus the full
    model's unit count (fractional for hybrid trailing layers)."""
    if cfg.family == "hybrid":
        return (dataclasses.replace(cfg, n_layers=units * cfg.hybrid_group,
                                    scan_layers=False),
                cfg.n_layers / cfg.hybrid_group)
    if cfg.family == "enc_dec":
        return (dataclasses.replace(cfg, enc_layers=units, dec_layers=units,
                                    n_layers=2 * units, scan_layers=False),
                cfg.enc_layers)
    return (dataclasses.replace(cfg, n_layers=units, scan_layers=False),
            cfg.n_layers)


def rules_for(cfg):
    rules = dict(partition.DEFAULT_RULES)
    if cfg.seq_shard:
        rules["seq"] = "model"        # SP: every seq constraint follows
    return rules


def measure_costs(cfg, shape, mesh, *,
                  max_len: int | None = None) -> dict[str, float]:
    """Run the cell's step on fake tensors under a :class:`StepCounter`
    -> {'flops', 'bytes', 'peak', 'coll/<op>', 'coll/total',
    'axis/<axis>/<op>'} per device, every op of every axis of ``mesh``
    present (zeros included), so that probes line up key for key."""
    with partition.mesh_rules(mesh, rules_for(cfg)), FakeTensorMode():
        step, args, _ = build_cell(cfg, shape, mesh, max_len=max_len)
        res = count(step, args, mesh)
    out = {"flops": float(res["flops"]), "bytes": float(res["bytes"]),
           "peak": float(res["peak_bytes"])}
    for op, v in res["collective_bytes"].items():
        out[f"coll/{op}"] = v
    for axis in list(mesh.shape) + sorted(set(res["collective_bytes_by_axis"])
                                         - set(mesh.shape)):
        per = res["collective_bytes_by_axis"].get(axis, {})
        for op in COLLECTIVE_OPS:
            out[f"axis/{axis}/{op}"] = per.get(op, 0.0)
    return out


def count_cell(cfg, shape, mesh_shape: tuple[int, ...],
               axes: tuple[str, ...] = ("data", "model"), *,
               max_len: int | None = None) -> dict[str, float]:
    """The dry run of one cell of any size on a mesh of ``mesh_shape`` over
    ``axes``, in a fake world of its ranks: :func:`measure_costs` and the
    rank's ``param_bytes`` (a prediction to hold a real run to)."""
    refuse_kernels(cfg)
    with fake_world(math.prod(mesh_shape)):
        mesh = fake_mesh(mesh_shape, axes)
        out = measure_costs(cfg, shape, mesh, max_len=max_len)
        out["param_bytes"] = param_bytes(cfg, shape, mesh)
    return out


def param_bytes(cfg, shape, mesh) -> float:
    """A rank's param bytes in the cell's step: training's float32 masters
    under the cell's rules, serving's stored params in its layout."""
    with partition.mesh_rules(mesh, rules_for(cfg)):
        if shape.kind == "train":
            return bytes_per_device(steps.param_sds(cfg),
                                    steps.param_shardings(cfg, mesh))
        return bytes_per_device(steps.serve_param_sds(cfg),
                                steps.serve_layout(cfg, mesh, 1, 1).params)


def extrapolated_costs(cfg, shape, mesh) -> dict[str, Any]:
    """The reference's depth probes: the cell at depths 1 and 2,
    extrapolated linearly, exact for homogeneous stacks:
        cost(L) = c1 + (L - 1) * (c2 - c1).
    Eager counting needs none (every layer is counted), so the dry run
    records this beside the full-depth count as a check."""
    p1, full_units = probe_cfg(cfg, 1)
    p2, _ = probe_cfg(cfg, 2)
    c1 = measure_costs(p1, shape, mesh)
    c2 = measure_costs(p2, shape, mesh)
    out = {k: c1[k] + (full_units - 1) * (c2[k] - c1[k]) for k in c1}
    out["probe_flops_1"] = c1["flops"]
    out["probe_flops_2"] = c2["flops"]
    out["full_units"] = full_units
    return out


def _apply_overrides(cfg, overrides: dict[str, Any] | None):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in (True, "true", "True", "1")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def refuse_kernels(cfg) -> None:
    """The dry run counts the plain versions: a kernel has no shape-only
    face, so ``use_pallas`` is refused here, before any step runs."""
    if cfg.use_pallas:
        raise ValueError("use_pallas: the CUDA kernels have no shape-only "
                         "(fake-tensor) face; the dry run counts the "
                         "plain versions, as the reference's does")


def axis_rate(mesh, axis: str, machine=costmodel.H100) -> float:
    """The collective rate (bytes/s a rank) of ``axis``'s groups: the
    slowest link a group crosses, ranks laid row-major onto nodes of
    ``machine.node_chips``."""
    sizes = list(mesh.shape.values())
    i = list(mesh.shape).index(axis)
    stride = math.prod(sizes[i + 1:])
    return costmodel.group_bw(machine, [k * stride
                                        for k in range(sizes[i])])


def roofline(rec: dict, mesh, machine=costmodel.H100) -> dict[str, Any]:
    """The three roofline terms of one device (seconds) at ``machine``'s
    rates; ``collective_s`` sums each axis's bytes over its rate."""
    terms = costmodel.roofline_time(rec["flops_per_device"],
                                    rec["hlo_bytes_per_device"],
                                    machine=machine)
    terms["collective_s"] = sum(
        by_op["total"] / axis_rate(mesh, axis, machine)
        for axis, by_op in rec["collective_bytes_by_axis"].items()
        if by_op["total"])
    terms["dominant"] = costmodel.dominant_term(terms)
    return terms


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True,
             overrides: dict[str, Any] | None = None) -> dict[str, Any]:
    cfg = _apply_overrides(configs.get(arch), overrides)
    refuse_kernels(cfg)
    shape = configs.SHAPES[shape_name]
    ok, reason = configs.applicable(cfg, shape)
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "kind": shape.kind}
    if overrides:
        rec["overrides"] = dict(overrides)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        return rec

    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi)
        mesh.device = torch.device(fake_device())
        chips = mesh_lib.chips(mesh)
        # --- 1. the full-depth step, counted op by op ----------------------
        t0 = time.time()
        full = measure_costs(cfg, shape, mesh)
        t_trace = time.time() - t0
        # --- 2. the reference's depth probes, as a check -------------------
        probe = extrapolated_costs(cfg, shape, mesh)
        rec["param_bytes_per_device"] = param_bytes(cfg, shape, mesh)
        extra = {"num_microbatches": cfg.force_microbatches
                 or steps.pick_microbatches(cfg, shape, mesh)} \
            if shape.kind == "train" else {}

    rec["memory_per_device_bytes"] = full["peak"]
    rec["flops_per_device"] = full["flops"]
    rec["hlo_bytes_per_device"] = full["bytes"]
    rec["collective_bytes"] = {k.split("/", 1)[1]: v for k, v in full.items()
                               if k.startswith("coll/")}
    by_axis: dict[str, dict[str, float]] = {}
    for k, v in full.items():
        if k.startswith("axis/"):
            _, axis, op = k.split("/")
            by_axis.setdefault(axis, {})[op] = v
    for per in by_axis.values():
        per["total"] = sum(per[op] for op in COLLECTIVE_OPS)
    rec["collective_bytes_by_axis"] = by_axis
    rec["probe"] = {k: probe[k] for k in
                    ("probe_flops_1", "probe_flops_2", "full_units")}
    rec["probe"]["extrapolated_flops"] = probe["flops"]
    rec["probe"]["flops_rel_diff"] = (
        abs(probe["flops"] - full["flops"]) / full["flops"]
        if full["flops"] else 0.0)
    total_p, active_p = count_params(M.param_shapes(cfg), cfg)
    rec["params_total"] = total_p
    rec["params_active"] = active_p
    rec["roofline"] = roofline(rec, mesh)
    mf = model_flops(cfg, shape, total_p, active_p)
    rec["model_flops_total"] = mf
    counted_total = max(rec["flops_per_device"], 0) * chips
    rec["useful_flops_ratio"] = (mf / counted_total) if counted_total > 0 \
        else None
    rec["chips"] = chips
    rec["fake_device"] = mesh.device.type
    rec["trace_s"] = round(t_trace, 2)
    rec["status"] = "ok"
    rec.update(extra)
    if verbose:
        terms = rec["roofline"]
        dom = terms["dominant"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(trace {t_trace:.1f}s, "
              f"{rec['memory_per_device_bytes'] / 1e9:.1f} GB/device, "
              f"dominant={dom} {terms[dom] * 1e3:.2f}ms, "
              f"useful_flops={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)})",
              flush=True)
    return rec


# ====================================================================== CLI
def load_results(path: str) -> dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cell_key(arch, shape, mesh_kind) -> str:
    return f"{arch}|{shape}|{mesh_kind}"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. --override moe_groups=16 "
                         "(repeatable; use_pallas=true is refused)")
    ap.add_argument("--tag", default="",
                    help="suffix for the results key (names the experiment)")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)
    try:                    # before any cell: every cell would refuse it
        refuse_kernels(_apply_overrides(configs.get(configs.arch_names()[0]),
                                        {k: v for k, v in overrides.items()
                                         if k == "use_pallas"}))
    except ValueError as e:
        ap.error(str(e))

    if args.list:
        for name, _, shape, ok, reason in configs.cells():
            print(f"{name:24s} {shape.name:12s} "
                  f"{'RUN' if ok else 'SKIP: ' + reason}")
        return

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(n, s.name) for n, _, s, _, _ in configs.cells()]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")

    results = load_results(args.out)
    for arch, shape in todo:
        for mk in meshes:
            key = cell_key(arch, shape, mk)
            if args.tag:
                key += f"#{args.tag}"
            if not args.force and results.get(key, {}).get("status") in (
                    "ok", "skipped"):
                print(f"[dryrun] {key}: cached, skipping")
                continue
            try:
                rec = run_cell(arch, shape, mk, overrides=overrides)
            except Exception as e:      # one cell's failure is its record
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"[dryrun] {key}: ERROR {type(e).__name__}: {e}")
            results[key] = rec
            save_results(args.out, results)


if __name__ == "__main__":
    main()
