"""Serving traffic driver: continuous batching under synthetic or traced load.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --paged --prefill-chunk 128 --requests 32 --capacity 8 \
        --prompt-len-min 16 --prompt-len-max 384 --new-tokens 16 \
        --new-tokens-max 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --requests 17 --capacity 8 --prompt-len-min 16 --prompt-len-max 384

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --requests 17 --capacity 8 --prompt-len-min 16 --prompt-len-max 384

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --requests 9 --capacity 4 \
        --prompt-len-min 16 --prompt-len-max 4500

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --requests 17 --capacity 8 \
        --prompt-len-min 4 --prompt-len-max 32 --new-tokens 32 \
        --new-tokens-max 64

serve the SSM family (mamba2-2.7b), the hybrid family (zamba2-7b),
sliding-window attention (h2o-danube-1.8b, a ring of 4096 positions per
slot) and the encoder-decoder (seamless-m4t-large-v2) through the
contiguous engine; ``--paged`` refuses all four, as the reference does.
Every encoder-decoder request shares one standard-normal (enc_len,
d_model) float32 encoder context drawn from the traffic rng, as the
reference's launcher draws it (the speech frontend is a stub).  The MoE
family (dbrx-132b, llama4-scout-17b-16e) and the
VLM (llava-next-34b) serve through either engine, ``--paged`` included;
a VLM request's prompt is a standard-normal (prompt_len, d_model) float32
embedding drawn from the traffic rng (the vision frontend is a stub, as in
the reference).  At full width neither dbrx-132b nor llama4-scout fits one
80 GB card; ``chip_smoke.py`` serves dbrx cut to 8 layers.  Generates a
mixed-prompt-length request stream (uniform lengths in
[--prompt-len-min, --prompt-len-max], Poisson arrivals at
--arrival-rate req/s; 0 = all at once), or replays ``--replay FILE`` — a
JSON list of ``{"prompt_len": int, "new_tokens": int, "arrival": float}``
records — and prints one ``[serve:continuous] {...}`` JSON line:
throughput, latency and TTFT percentiles, and the engine's
queue/occupancy/prefill-decode stats.
Weights are random, from ``--seed``.

Runs on ``--device`` (default ``cuda``; asking for CUDA where there is none
fails — pass ``--device cpu`` for the CPU).  ``--trace PATH`` writes a
Chrome-trace JSON of the run, ``--metrics-json PATH`` the engine's
metrics-registry snapshot, and ``--static`` runs the same stream through
the static-batch baseline engine.  ``--paged`` serves from the paged KV
cache: ``--page-size``/``--num-pages`` set the pool, ``--prefill-chunk N``
interleaves long-prompt prefill with decode, ``--no-prefix-cache`` /
``--admission`` set sharing and overload policy.  ``--sip-cache PATH``
serves inside ``schedule_cache(PATH)``, so the kernels run the schedules
``repro_torch.launch.tune`` persisted there (the default schedule for any
shape the store lacks).  ``--record-workloads PATH`` streams the live
(shape, dtype, occupancy) mix to a replayable JSONL
(``repro_torch.obs.WorkloadRecorder``; ``repro_torch.launch.autotune``
tails it from another process).

``--autotune`` (requires ``--sip-cache``) runs the always-on tuning service
(``repro_torch.autotune``) on a background thread: every
``--autotune-interval`` seconds it drains the live mix, tunes up to
``--autotune-budget`` workloads in a shadow store on ``--device`` (on the
card, on a CUDA stream of its own), gates candidates through the
correctness sweep and energy margin, and commits winners into the live
store — the engine hot-swaps them before its next dispatch, no restart.
Decisions journal to ``--autotune-log`` (summarize with
``repro_torch.launch.obsreport --kind autotune``).

``--mesh N`` serves tensor-parallel over a 1-D ``("model",)`` mesh of N
ranks, one process each on this host (``repro_torch.dist.spawn``), rank r
on ``cuda:(r % device_count)`` (NCCL when every rank has a card of its
own, else gloo: two ranks sharing one card), or on the CPU with ``--device
cpu`` (gloo).  On the manual path each rank holds its share of the heads,
kv heads and MLP hidden dim and all-reduces the two seams of every layer
(``--compressed-collectives``: int8 payloads, not token-exact).  On the
GSPMD path (``--tp-mode gspmd``, or ``auto`` on a config the manual path
cannot shard, ``dist.tp.tp_eligible``: mamba2, zamba2, seamless, padded
heads, heads that do not divide the mesh) each rank keeps its
``SERVE_RULES`` blocks of the params and caches and gathers a layer at a
time (``serve/engine.py``).  Rank 0 decides when each request is due and
every rank submits the same requests and steps the same number of times;
after the run the ranks' tokens are compared, and rank 0 prints the JSON
line with ``"mesh"``, ``"tp_path"``, ``"tp_reason"`` and ``"backend"``
added.  With ``--autotune`` the service runs on rank 0, tuning what that
rank dispatches; its promotions and evictions are staged and broadcast at
the next step boundary, and every rank applies them to its own store, so
all ranks swap before the same dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --paged --prefill-chunk 128 --requests 17 --mesh 2

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --requests 3 --new-tokens 3 --mesh 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.core.cache import ScheduleCache
from repro_torch.core.registry import cache_for_path, schedule_cache
from repro_torch.dist import spawn
from repro_torch.launch.mesh import MESH_TIMEOUT_S, Mesh, mesh_for
from repro_torch.models import model as M
from repro_torch.serve.engine import (ContinuousEngine, Engine, ServeConfig,
                                      static_batches)

@dataclasses.dataclass
class TrafficSpec:
    prompt_len: int
    new_tokens: int
    arrival: float      # seconds after driver start


def make_traffic(args, rng: np.random.Generator) -> list[TrafficSpec]:
    if args.replay:
        with open(args.replay) as f:
            records = json.load(f)
        return [TrafficSpec(int(r["prompt_len"]), int(r["new_tokens"]),
                            float(r.get("arrival", 0.0))) for r in records]
    arrivals = np.zeros(args.requests)
    if args.arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             args.requests))
    return [TrafficSpec(
        int(rng.integers(args.prompt_len_min, args.prompt_len_max + 1)),
        int(rng.integers(args.new_tokens,
                         max(args.new_tokens_max, args.new_tokens) + 1)),
        float(a)) for a in arrivals]


def _pct(xs: list[float]) -> dict[str, float]:
    if not xs:
        return {}
    return {p: round(float(np.percentile(xs, q)) * 1e3, 1)
            for p, q in (("p50_ms", 50), ("p95_ms", 95), ("p99_ms", 99))}


def _due(traffic: list[TrafficSpec], order: list[int], i: int, t0: float,
         idle: bool) -> int:
    """How far into ``order`` the requests are due now; with nothing in
    flight, sleeps until the next arrival first."""
    now = time.perf_counter() - t0
    if idle and i < len(order) and traffic[order[i]].arrival > now:
        time.sleep(traffic[order[i]].arrival - now)
        now = traffic[order[i]].arrival
    while i < len(order) and traffic[order[i]].arrival <= now:
        i += 1
    return i


def schedule_sync(mesh: Mesh, store: ScheduleCache,
                  staging=None) -> Callable[[], None]:
    """The step-boundary hook of ``--autotune`` on a mesh: every rank
    applies to ``store`` what the first rank's service staged
    (``staging``, None on the other ranks), broadcast from it."""
    from repro_torch.autotune import apply_staged

    def sync() -> None:
        apply_staged(store, mesh.broadcast_object(
            staging.take() if staging is not None else None))
    return sync


def drive_continuous(eng: ContinuousEngine, traffic: list[TrafficSpec],
                     prompts: list[np.ndarray], extras=None,
                     mesh: Mesh | None = None,
                     sync: Callable[[], None] | None = None) -> dict:
    """Submit the traffic at its arrival times and step the engine until
    it drains.  On a mesh the ranks must take the same steps: the first
    rank of the ``"model"`` axis decides on its clock which requests are
    due and broadcasts how many, and after the run the ranks' tokens are
    compared (a difference raises).  ``sync`` runs on every rank at every
    step boundary (``schedule_sync``)."""
    order = sorted(range(len(traffic)), key=lambda i: traffic[i].arrival)
    handles = []
    t0 = time.perf_counter()
    i = 0
    while i < len(order) or not eng.pool.idle:
        due = _due(traffic, order, i, t0, eng.pool.idle)
        if mesh is not None:
            due = mesh.broadcast_int(due, "model")
        if sync is not None:
            sync()
        for j in order[i:due]:
            handles.append(eng.submit(prompts[j], traffic[j].new_tokens,
                                      extra=extras[j] if extras else None))
        i = due
        if not eng.pool.idle:
            eng.step()
    wall = time.perf_counter() - t0
    if mesh is not None:
        outputs = [r.tokens for r in handles]
        every = [None] * mesh.shape["model"]
        dist.all_gather_object(every, outputs, group=mesh.group("model"))
        if any(o != outputs for o in every):
            raise RuntimeError("tensor-parallel ranks emitted different "
                               "tokens")
    lat = [r.finished_at - r.submitted_at for r in handles]
    ttft = [r.admitted_at - r.submitted_at for r in handles]
    toks = sum(len(r.tokens) for r in handles)
    # top-level tokens_per_s is WALL-clock (includes arrival idle time) and
    # comparable to drive_static's; the engine's busy-time rates live under
    # "engine"
    return {"wall_s": round(wall, 3), "tokens": toks,
            "tokens_per_s": round(toks / wall, 1),
            "latency": _pct(lat), "ttft": _pct(ttft),
            "engine": {k: round(v, 3) for k, v in eng.metrics().items()}}


def drive_static(eng: Engine, traffic: list[TrafficSpec],
                 prompts: list[np.ndarray], extras, capacity: int) -> dict:
    """Baseline: batches of ``capacity`` in arrival order, prompts padded to
    the batch max, every batch decoding to its longest request."""
    order = sorted(range(len(traffic)), key=lambda i: traffic[i].arrival)
    aprompts = [prompts[j] for j in order]
    abudgets = [traffic[j].new_tokens for j in order]
    t0 = time.perf_counter()
    toks = 0
    for padded, new, idxs in static_batches(aprompts, abudgets, capacity):
        ei = None
        if extras:
            ei = {k: _stack_extra(k, [extras[order[j]][k] for j in idxs],
                                  padded.shape[1])
                  for k in extras[0]}
        eng.generate(padded, new, extra_inputs=ei)
        toks += sum(abudgets[j] for j in idxs)              # useful tokens
    wall = time.perf_counter() - t0
    return {"wall_s": round(wall, 3), "tokens": toks,
            "tokens_per_s": round(toks / wall, 1)}


def _stack_extra(key: str, values: list[np.ndarray], plen: int) -> np.ndarray:
    """Batch per-request extra inputs; prompt-aligned extras (VLM embeds)
    are left-padded to the batch prompt length like the tokens."""
    if key != "embeds":
        return np.stack(values)
    out = np.zeros((len(values), plen) + values[0].shape[1:],
                   values[0].dtype)
    for r, v in enumerate(values):
        out[r, plen - v.shape[0]:] = v
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.arch_names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8,
                    help="decode-batch slots")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals, requests/s (0 = all at start)")
    ap.add_argument("--replay", default=None,
                    help="JSON request trace to replay (overrides synthetic "
                         "traffic)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON of the run")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine's metrics-registry snapshot")
    ap.add_argument("--record-workloads", default=None,
                    help="record the live workload mix to a replayable "
                         "JSONL (repro_torch.obs.WorkloadRecorder)")
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--new-tokens-max", type=int, default=0,
                    help="uniform in [--new-tokens, this] when > 0")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="run the static-batch baseline engine instead")
    ap.add_argument("--paged", action="store_true",
                    help="serve from a paged KV cache instead of per-slot "
                         "contiguous segments")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV cache page (with --paged)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page budget incl. the trash page (0 = contiguous-"
                         "equivalent memory: capacity*ceil(max_len/ps)+1)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size (0 = whole-prompt prefills); "
                         "with --paged only")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable content-hashed prefix sharing (with "
                         "--paged)")
    ap.add_argument("--admission", choices=("queue", "reject"),
                    default="queue",
                    help="paged admission policy when pages/slots are "
                         "unavailable at submit time")
    ap.add_argument("--sip-cache", default=None,
                    help="serve the SIP-tuned schedules of this schedule "
                         "cache (repro_torch.launch.tune --cache)")
    ap.add_argument("--autotune", action="store_true",
                    help="run the always-on autotune service alongside the "
                         "engine: tune the live mix, gate, hot-swap winners "
                         "into --sip-cache (see repro_torch.autotune)")
    ap.add_argument("--autotune-interval", type=float, default=10.0,
                    help="seconds between autotune cycles")
    ap.add_argument("--autotune-budget", type=int, default=2,
                    help="workloads tuned per autotune cycle")
    ap.add_argument("--autotune-log", default=None,
                    help="autotune decision journal JSONL (default: "
                         "<sip-cache>.autotune.jsonl)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve tensor-parallel over N ranks, one process "
                         "each (1-D 'model' mesh; shards heads/kv-heads/"
                         "mlp); rank r on cuda:(r % device_count), or the "
                         "CPU with --device cpu")
    ap.add_argument("--tp-mode", choices=("auto", "shard_map", "gspmd"),
                    default="auto",
                    help="tensor-parallel path with --mesh: the manual "
                         "seams (shard_map) or the GSPMD layout (gspmd); "
                         "auto = shard_map when the config is TP-eligible")
    ap.add_argument("--compressed-collectives", action="store_true",
                    help="int8-compress the two per-layer seam all-reduces "
                         "(with --mesh).  Approximate: trades exact token "
                         "parity for collective bytes")
    args = ap.parse_args(argv)
    if args.autotune and not args.sip_cache:
        ap.error("--autotune requires --sip-cache (a live store to promote "
                 "into)")
    if args.autotune and args.static:
        ap.error("--autotune requires the continuous engine (drop --static)")
    if args.static and args.mesh:
        ap.error("--mesh requires the continuous engine (drop --static)")
    if args.compressed_collectives and not args.mesh:
        ap.error("--compressed-collectives requires --mesh")
    if args.mesh:
        M.resolve_device(args.device)
        spawn.run(_serve_rank, args.mesh, args=(args,), device=args.device,
                  timeout_s=MESH_TIMEOUT_S, deadline_s=float("inf"))
    else:
        serve(args)


def _autotune(args, eng: ContinuousEngine, recorder, reg, mesh):
    """``--autotune``: the service beside ``eng`` (on a mesh, on its first
    rank only, staging its writes) and the step-boundary sync a mesh
    needs.  -> (service or None, sync or None).  The service tunes what
    this engine dispatches: ``eng.cfg``, a manual-path rank's local
    config."""
    from repro_torch.autotune import (AutotuneConfig, AutotuneService,
                                      EventLog, Staging, TuneHistory,
                                      recorder_source, serve_targets)
    from repro_torch.tuning.state import SearchState
    store = cache_for_path(args.sip_cache)
    staging = Staging() if mesh is not None and mesh.rank == 0 else None
    sync = None if mesh is None else schedule_sync(mesh, store, staging)
    if mesh is not None and mesh.rank != 0:
        return None, sync
    state_path = args.sip_cache + ".autotune.state.json"
    service = AutotuneService(
        store, source=recorder_source(recorder),
        target_for=serve_targets(eng.cfg, eng.scfg),
        config=AutotuneConfig(interval_s=args.autotune_interval,
                              budget=args.autotune_budget),
        history=TuneHistory(args.sip_cache + ".history.json"),
        state=(SearchState.load(state_path)
               or SearchState(path=state_path)),
        log=EventLog(args.autotune_log
                     or args.sip_cache + ".autotune.jsonl"),
        obs=reg, device=args.device, staging=staging)
    return service, sync


def _serve_rank(rank: int, args) -> dict:
    """One rank of ``--mesh``: the mesh over the job's ranks, then
    :func:`serve` on it."""
    return serve(args, mesh_for((args.mesh,), ("model",)))


def serve(args, mesh: Mesh | None = None) -> dict:
    """Serve the traffic ``args`` describe (on one rank of ``mesh`` when it
    is given) and print the report; with a mesh only its first rank prints
    and writes the trace, metrics and workload files.  Returns the
    report."""
    lead = mesh is None or mesh.rank == 0
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = M.init_lm(cfg, seed=args.seed, device=mesh.device if mesh
                       else args.device)
    rng = np.random.default_rng(args.seed)
    traffic = make_traffic(args, rng)
    # global maxima, not max(plen_i + new_i): a static batch left-pads to its
    # longest prompt AND decodes to its largest budget
    max_len = (max(t.prompt_len for t in traffic)
               + max(t.new_tokens for t in traffic))
    scfg = ServeConfig(max_len=max_len, temperature=args.temperature,
                       capacity=args.capacity, seed=args.seed,
                       paged=args.paged, page_size=args.page_size,
                       num_pages=args.num_pages or None,
                       prefill_chunk=args.prefill_chunk or None,
                       prefix_cache=not args.no_prefix_cache,
                       admission=args.admission, tp_mode=args.tp_mode,
                       compressed_collectives=args.compressed_collectives)
    prompts = [rng.integers(0, cfg.vocab, t.prompt_len).astype(np.int32)
               for t in traffic]
    extras = None
    if cfg.family == "enc_dec":
        ctx = rng.standard_normal(
            (cfg.enc_len, cfg.d_model)).astype(np.float32)
        extras = [{"enc_embeds": ctx} for _ in traffic]
    elif cfg.input_mode == "embeddings":
        # VLM: the prompt is precomputed patch+text embeddings (frontend stub)
        extras = [{"embeds": rng.standard_normal(
            (t.prompt_len, cfg.d_model)).astype(np.float32)}
            for t in traffic]

    tracer = obs.Tracer() if args.trace and lead else None
    # streaming mode: records hit the JSONL as they happen, so an external
    # autotune daemon can tail the file while this process serves
    recorder = (obs.WorkloadRecorder(args.record_workloads)
                if args.record_workloads and lead
                else obs.WorkloadRecorder() if args.autotune and lead
                else None)
    reg = obs.MetricsRegistry()
    service = sync = None
    with contextlib.ExitStack() as stack:
        if tracer is not None:
            stack.enter_context(obs.tracing(tracer))
        if args.sip_cache:
            stack.enter_context(schedule_cache(args.sip_cache))
        if args.static:
            report = drive_static(Engine(params, cfg, scfg), traffic, prompts,
                                  extras, args.capacity)
            print(f"[serve:static] {json.dumps(report)}")
        else:
            eng = ContinuousEngine(params, cfg, scfg,
                                   example_extra=extras[0] if extras
                                   else None, obs=reg, recorder=recorder,
                                   mesh=mesh)
            del params          # a mesh rank keeps only its slice
            if args.autotune:
                service, sync = _autotune(args, eng, recorder, reg, mesh)
            if service is not None:
                service.start()
            try:
                report = drive_continuous(eng, traffic, prompts, extras,
                                          mesh=mesh, sync=sync)
            finally:
                if service is not None:
                    service.stop()
                    service.log.close()
            if mesh is not None:
                report.update(mesh=list(mesh.shape.values()),
                              tp_path=eng.tp_path, tp_reason=eng.tp_reason,
                              backend=mesh.backend)
            if lead:
                print(f"[serve:continuous] {json.dumps(report)}")
            if service is not None:
                print(f"[serve] autotune: {json.dumps(service.metrics())}")
    if tracer is not None:
        tracer.save(args.trace)
        print(f"[serve] trace written to {args.trace}")
    if args.metrics_json and lead:
        reg.save_json(args.metrics_json)
        print(f"[serve] metrics snapshot written to {args.metrics_json}")
    if recorder is not None:
        recorder.close()
        if args.record_workloads:
            print(f"[serve] workload mix ({len(recorder)} records) written "
                  f"to {args.record_workloads}")
    return report


if __name__ == "__main__":
    main()
