"""The train steps and the shape and sharding helpers (the port of
``repro/launch/steps.py``).

``train_step`` does loss + grad (with optional microbatch accumulation in
float32) + AdamW on one device, on the plain versions of the model's
kernels (``use_pallas`` off), as the reference trains: the kernels have no
backward.  :func:`sharded_train_step` is the same step on a rank of a
``("pod", "data", "model")`` mesh (see its docstring).  The shape records
(``batch_sds``, ``cache_sds``, ``decode_tokens_sds``) are tensors on the
``meta`` device, and the sharding helpers resolve them against the
logical-axis rules (``dist/partition.py``).  :func:`prefill_step` and
:func:`serve_step` are the serving steps of the dry run
(``launch/dryrun.py``): ``M.prefill`` and ``M.decode_step`` on one device,
or on a rank of a mesh under the GSPMD serving layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec
from repro_torch.dist import partition
from repro_torch.dist import tp as tp_lib
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw


def loss_and_grads(params, batch, *, cfg: ModelConfig,
                   num_microbatches: int = 1,
                   denoms: Sequence[torch.Tensor] | None = None,
                   share: float = 1.0, view=None):
    """(metrics, float32 grads) of ``M.loss_fn`` at ``params``.  Gradients
    flow to detached aliases of the leaves (no copy, and the caller's
    tensors are not marked), so params need not require grad.  A leaf the
    loss never reads (an embeddings-mode model's ``embed``) gets a zero
    gradient, as ``jax.grad`` gives it.  With ``num_microbatches > 1`` the
    batch's leading dim is cut into that many slices and their gradients
    and metrics are summed in float32 and divided by the count.  The model
    runs with ``cfg.use_pallas`` off: the kernels' plain, differentiable
    versions.  ``denoms`` (one a microbatch) and ``share`` make each
    microbatch's loss a slice's part of a larger batch's
    (``M.loss_fn``).  ``view``, when given, maps the tree of leaves to
    the tree the model reads (views of them: a sharded step's kv head);
    the gradients stay the leaves'."""
    cfg = dataclasses.replace(cfg, use_pallas=False)
    flat = adamw.leaves(params)
    alias = {id(t): t.detach().requires_grad_() for t in flat}
    live = M.map_params(lambda _, t: alias[id(t)], params)
    inputs = [alias[id(t)] for t in flat]

    def one(b, denom):
        with torch.enable_grad():
            tree = live if view is None else view(live)
            total, metrics = M.loss_fn(tree, b, cfg, denom=denom, share=share)
            grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 if g is None else g.to(torch.float32)
                 for t, g in zip(flat, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    n = max(num_microbatches, 1)
    denoms = [None] * n if denoms is None else list(denoms)
    if n == 1:
        metrics, grads = one(batch, denoms[0])
    else:
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"a batch of {batch['labels'].shape[0]} rows "
                             f"does not split into {n} microbatches")
        parts = [dict(zip(batch, vals)) for vals in
                 zip(*(v.chunk(n, dim=0) for v in batch.values()))]
        metrics, grads = _zero_metrics(flat[0].device), None
        for b, denom in zip(parts, denoms):
            m, g = one(b, denom)
            grads = g if grads is None else [a.add_(x)
                                             for a, x in zip(grads, g)]
            metrics = {k: metrics[k] + m[k] for k in metrics}
        grads = [g.div_(n) for g in grads]
        metrics = {k: v / n for k, v in metrics.items()}
    by_leaf = {id(t): g for t, g in zip(flat, grads)}
    return metrics, M.map_params(lambda _, t: by_leaf[id(t)], params)


def train_step(params, opt_state, batch, *, cfg: ModelConfig,
               opt_cfg: adamw.OptConfig, num_microbatches: int = 1):
    """One optimizer step -> (params, opt_state, metrics), params and state
    updated in place; metrics are 0-dim tensors on the params' device
    (``loss``, the aux losses, ``lr``, ``grad_norm``)."""
    metrics, grads = loss_and_grads(params, batch, cfg=cfg,
                                    num_microbatches=num_microbatches)
    params, opt_state, opt_metrics = adamw.adamw_update(
        grads, opt_state, params, opt_cfg)
    return params, opt_state, {**metrics, **opt_metrics}


def _zero_metrics(device: torch.device | str = "cpu") -> dict[str, Any]:
    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": zero(), "aux/load_balance": zero(), "aux/router_z": zero()}


# ======================================================== the sharded step
#: the mesh axes the batch splits over, outermost first
DATA_AXES = ("pod", "data")


def data_ways(mesh) -> int:
    """The number of batch slices on ``mesh``: its pod x data size."""
    return math.prod(mesh.shape[a] for a in DATA_AXES if a in mesh.shape)


def data_index(mesh) -> int:
    """This rank's batch slice: its (pod, data) coordinates, row-major."""
    i = 0
    for a in DATA_AXES:
        if a in mesh.shape:
            i = i * mesh.shape[a] + mesh.coord(a)
    return i


def loss_mode(cfg: ModelConfig, mesh, rows: int, seq_len: int,
              num_microbatches: int = 1) -> str:
    """How :func:`sharded_train_step` forms the loss of a batch of ``rows``
    rows of ``seq_len`` tokens:
    ``"split"`` when each data rank can run its slice of every microbatch
    and the sum over the slices is the whole batch's loss (a dense model,
    an MoE model whose dispatch groups fall within a slice), else
    ``"global"``: every data rank runs the whole batch (an MoE model whose
    routing and capacity span the batch, or rows that do not split
    evenly)."""
    d, n = data_ways(mesh), max(num_microbatches, 1)
    if d == 1:
        return "split"
    if rows % (d * n):
        return "global"
    if cfg.family == "moe":
        g = cfg.moe_groups
        if not g or g % d or rows // n * seq_len % g:
            return "global"
    return "split"


def _local_rows(x: torch.Tensor, d: int, i: int, n: int) -> torch.Tensor:
    """Data slice ``i`` of ``d`` of every one of ``n`` microbatches of the
    rows of ``x``, in microbatch order: microbatch j's slice is rows
    ``j R/n + i R/(n d)`` onwards, ``R/(n d)`` of them."""
    r = x.shape[0]
    return x.reshape((n, d, r // (n * d)) + x.shape[1:])[:, i] \
        .reshape((r // d,) + x.shape[1:])


def _items(tree, path: tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) of a nested dict in sorted key order, the order of
    ``adamw.leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    else:
        yield path, tree


def _all_reduce_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed in place over the mesh's data ranks."""
    for a in DATA_AXES:
        if mesh.shape.get(a, 1) > 1:
            dist.all_reduce(x, group=mesh.group(a))
    return x


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """How a rank of a mesh with a ``"model"`` axis runs its step's compute
    split along it (:func:`model_split`): ``cfg``, the rank's local config
    (its heads, kv heads, hidden dim; an SSM mixer reads its heads' share
    from the scope, ``models/ssm.py``); ``cut``, the seams whose params the
    rank holds cut (``dist.tp.TRAIN_SEAMS``); ``whole``, the paths of
    ``"model"``-cut leaves gathered whole all the same (their compute is
    replicated); ``summed``, the paths of leaves replicated along
    ``"model"`` but read inside a cut region, whose gradients are partial
    and summed over ``"model"``; ``kv``, the kv head this rank's query
    heads map to where the kv heads are fewer than the ranks (the rank
    reads that head of the replicated ``wk``/``wv``), else None;
    ``attn``, the paths of the attention subtrees the seams cut (an
    encoder-decoder's three: the encoder's, the decoder's self- and
    cross-attention); ``caches``, on the serving path, the cache subtrees
    (their paths) the rank computes as its blocks."""

    cfg: ModelConfig
    cut: frozenset
    whole: frozenset
    summed: frozenset
    kv: int | None
    attn: tuple[tuple[str, ...], ...] = (("blocks", "attn"),)
    caches: frozenset = frozenset()

    def view(self, tree):
        """The tree the rank's model reads: ``tree`` with every attention
        subtree's ``wk``/``wv`` narrowed to :attr:`kv`."""
        if self.kv is None:
            return tree
        for top, leaf in self.attn:
            attn = tree[top][leaf]
            attn = {**attn, **{k: attn[k].narrow(-2, self.kv, 1)
                               for k in ("wk", "wv")}}
            tree = {**tree, top: {**tree[top], leaf: attn}}
        return tree


#: the leaves each seam cuts, by their path's last two names
_SEAM_LEAVES = {"attn": {(a, k) for a in ("attn", "xattn")
                         for k in ("wq", "wk", "wv", "wo")},
                "mlp": {("ffn", k) for k in ("w_gate", "w_up", "w_down")},
                "experts": {("ffn", k) for k in ("w_gate", "w_up",
                                                 "w_down")},
                "router": {("ffn", "router")},
                "vocab": {("embed",), ("dec_embed",), ("lm_head",)},
                "ssm": {("mixer", k) for k in ("in_proj", "conv_w",
                                               "conv_b", "A_log", "D",
                                               "dt_bias", "norm",
                                               "out_proj")}}
#: an SSM mixer's leaves that lie in contiguous blocks of concatenated
#: columns, re-laid by heads at use (``partition.relay``)
RELAID = ("in_proj", "conv_w", "conv_b")
#: the families whose compute a split covers; the serving path splits
#: those the manual path does not serve (its own seams split the others)
SPLIT_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "enc_dec")
SERVE_SPLIT_FAMILIES = ("ssm", "hybrid", "enc_dec")
#: each family's attention subtrees, and the blocks whose ``ffn`` holds
#: its dense MLP or MoE (every other family's: ``blocks/attn``, ``blocks``)
_ATTN_TREES = {"ssm": (),
               "hybrid": (("shared_attn", "attn"),),
               "enc_dec": (("enc_blocks", "attn"), ("dec_blocks", "attn"),
                           ("dec_blocks", "xattn"))}
_FFN_TREES = {"ssm": (), "hybrid": ("shared_attn",),
              "enc_dec": ("enc_blocks", "dec_blocks")}
#: each family's serving caches that the attention seam computes as the
#: rank's blocks (their paths in the cache tree)
_ATTN_CACHES = {"hybrid": {("attn",)}, "enc_dec": {("self",), ("cross",)}}


def model_split(cfg: ModelConfig, mesh, shardings, *,
                serving: bool = False) -> ModelSplit | None:
    """How :func:`sharded_train_step` splits the compute of ``cfg`` along
    ``mesh``'s ``"model"`` axis, the params laid out by ``shardings``, as
    GSPMD does under the reference's rules; None where it replicates it
    (no ``"model"`` extent, or padded heads, which the seams do not cover:
    their leaves are gathered whole).

    * an SSM mixer (ssm, and a hybrid's mamba blocks): the rank's heads
      where the heads divide the ranks (``A_log`` cut), its ``in_proj``
      and conv re-laid by heads (a leaf the divisibility fallback keeps
      whole is sliced, and its gradient summed);
    * attention (a hybrid's shared block's too; an encoder-decoder's
      encoder, decoder and cross-attention, which share their head
      counts): the rank's heads where every subtree's ``wq`` is cut and
      its kv heads are cut too or fewer than the ranks and dividing them;
      else their leaves are gathered whole and their compute replicated
      (heads that do not divide the ranks);
    * the dense MLP (a hybrid's shared one, an encoder-decoder's encoder's
      and decoder's), or an MoE's experts' hidden dim: the rank's share of
      it where cut;
    * an MoE whose experts are cut (they divide the ranks): its router's
      and FFN's experts (expert-parallel), routing replicated;
    * the embedding (an encoder-decoder's ``dec_embed``) and lm_head: the
      rank's vocab block where cut.

    ``serving`` gives the GSPMD serving path's split (its dispatches run
    under ``partition.materialising``): only the families the manual path
    does not serve (``SERVE_SPLIT_FAMILIES``), the attention only where
    its kv heads are cut, and no vocab seam (the embedding is looked up by
    ``take``, the logits' columns gathered); ``caches`` names the cache
    subtrees its ranks compute as their blocks."""
    n = mesh.shape.get("model", 1)
    families = SERVE_SPLIT_FAMILIES if serving else SPLIT_FAMILIES
    if n == 1 or cfg.family not in families or cfg.padded_heads:
        return None
    cut, summed, local, kv = set(), set(), {}, None
    mixers = {"ssm": ("blocks",), "hybrid": ("groups", "trailing")}.get(
        cfg.family, ())
    mixers = [m for m in mixers if m in shardings]
    if mixers and shardings[mixers[0]]["mixer"]["A_log"].cuts("model"):
        cut.add("ssm")
        summed |= {(m, "mixer", k) for m in mixers for k in RELAID
                   if not shardings[m]["mixer"][k].cuts("model")}
    trees = _ATTN_TREES.get(cfg.family, (("blocks", "attn"),))
    attns = [shardings[top][leaf] for top, leaf in trees]
    if attns:
        kv_cut = all(a["wk"].cuts("model") for a in attns)
        if all(a["wq"].cuts("model") for a in attns) and (
                kv_cut or (not serving and n % cfg.n_kv_heads == 0)):
            cut.add("attn")
            local.update(n_heads=cfg.n_heads // n,
                         n_kv_heads=cfg.n_kv_heads // n if kv_cut else 1)
            names = ("wk", "wv") if not kv_cut else ()
            names += ("q_norm", "k_norm") if cfg.qk_norm else ()
            summed |= {t + (k,) for t in trees for k in names}
            if not kv_cut:
                kv = mesh.coord("model") // (n // cfg.n_kv_heads)
    ffns = [shardings[t]["ffn"]
            for t in _FFN_TREES.get(cfg.family, ("blocks",))]
    if cfg.family == "moe" and ffns[0]["router"].cuts("model"):
        cut |= {"router", "experts"}
    elif ffns and all(f["w_up"].cuts("model") for f in ffns):
        cut.add("mlp")
        local["d_ff"] = cfg.d_ff // n
    embed = "dec_embed" if cfg.family == "enc_dec" else "embed"
    if not serving and shardings[embed].cuts("model") and \
            shardings["lm_head"].cuts("model"):
        cut.add("vocab")
    covered = set().union(*(_SEAM_LEAVES[c] for c in cut))
    whole = {path for path, sh in _items(shardings)
             if sh.cuts("model") and path[-2:] not in covered
             and path[-1:] not in covered}
    caches = set()
    if serving:
        if "ssm" in cut:
            caches |= {()} if cfg.family == "ssm" else {("mamba",),
                                                        ("trailing",)}
        if "attn" in cut:
            caches |= _ATTN_CACHES[cfg.family]
    if cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, head_dim=cfg.hd, **local)
    return ModelSplit(cfg, frozenset(cut), frozenset(whole),
                      frozenset(summed), kv, tuple(trees),
                      frozenset(caches))


def _gathered_axes(mesh, split: ModelSplit | None,
                   path: tuple[str, ...]) -> tuple[str, ...]:
    """The mesh axes a leaf is gathered over for the step: every axis, or
    under a split every axis but ``"model"`` (unless the leaf is in its
    ``whole``)."""
    if split is None or path in split.whole:
        return tuple(mesh.shape)
    return tuple(a for a in mesh.shape if a != "model")


def sharded_train_step(params, opt_state, batch, *, cfg: ModelConfig,
                       opt_cfg: adamw.OptConfig, mesh, shardings,
                       num_microbatches: int = 1):
    """One optimizer step on a rank of ``mesh``, GSPMD's contract: the math
    of :func:`train_step` on the global ``batch``.  ``params`` and
    ``opt_state`` are this rank's shards (``shardings``: the params' tree
    of :class:`~repro_torch.dist.partition.NamedSharding`; the moments lie
    as the params), updated in place.

    * Along ``"model"`` the compute is split as :func:`model_split` says:
      each leaf is gathered over the other axes only (the FSDP ``embed``
      cut over ``"data"``), so a rank holds its block of every leaf that
      ``"model"`` cuts and runs its local config inside
      ``dist.tp.training``, whose seams sum the partial products (an SSM
      mixer re-lays its ``in_proj`` and conv blocks by heads, and their
      gradients go back to the blocks).  The families it does not cover
      gather every leaf whole and replicate their compute along
      ``"model"``.
    * In ``"split"`` mode (:func:`loss_mode`) the rank runs its slice of
      every microbatch's rows; each slice's loss divides its token sum by
      the whole microbatch's token count (one all-reduce of the counts),
      and its aux losses (an MoE model's, over its own dispatch groups) are
      scaled by its share, so the sum over the data ranks is the whole
      batch's.  In ``"global"`` mode every data rank runs the whole batch.
    * The gradients are summed (split) or averaged (global) over the data
      ranks, leaf by leaf, a leaf that ``"data"`` cuts by a reduce-scatter
      (the rank keeps its shard), every other by an all-reduce; a
      replicated leaf read inside a cut region is first summed over
      ``"model"``, and a leaf gathered whole is cut to the rank's block.
      The global norm sums each shard's squares over the axes that cut
      it, a replicated leaf once; AdamW runs on the shards.

    -> (params, opt_state, metrics): the metrics of :func:`train_step`, the
    whole batch's, and ``mode``.  Its parts are ``train.gather``,
    ``train.grads``, ``train.reduce`` and ``train.adamw`` spans (host time:
    device work shows in the span where the host next waits for it, a
    collective's copy to the host)."""
    n = max(num_microbatches, 1)
    rows, seq = batch["labels"].shape
    mode = loss_mode(cfg, mesh, rows, seq, n)
    split = model_split(cfg, mesh, shardings)
    with obs_trace.span("train.gather"):
        full = M.map_params(lambda path, t: _at(shardings, path).gather(
            t, _gathered_axes(mesh, split, path)), params)
    with obs_trace.span("train.grads", mode=mode):
        if split is None:
            metrics, grads = _grads(full, batch, cfg, mesh, mode, n)
        else:
            with tp_lib.training(mesh.group("model"), mesh.coord("model"),
                                 mesh.shape["model"], split.cut):
                metrics, grads = _grads(full, batch, split.cfg, mesh, mode,
                                        n, view=split.view)
    del full
    whole = list(_items(grads))     # the only references: freed leaf by leaf
    del grads
    with obs_trace.span("train.reduce"):
        grads, norm = _reduce_grads(whole, shardings, mesh, mode, split)
    with obs_trace.span("train.adamw"):
        params, opt_state, opt_metrics = adamw.adamw_update(
            grads, opt_state, params, opt_cfg, norm=norm)
    return params, opt_state, {**metrics, **opt_metrics, "mode": mode}


def _at(tree, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _grads(full, batch, cfg: ModelConfig, mesh, mode: str, n: int,
           view=None):
    """(metrics, float32 gradients of the gathered leaves) of this rank's
    part of the step: its rows of every microbatch (split) or the whole
    batch (global)."""
    d = data_ways(mesh)
    rows = batch["labels"].shape[0]
    if mode == "split" and d > 1:
        i = data_index(mesh)
        local = {k: _local_rows(v, d, i, n) for k, v in batch.items()}
        mask = local.get("mask")
        if mask is None:
            counts = torch.full((n,), rows // n * local["labels"].shape[1],
                                dtype=torch.float32, device=mesh.device)
        else:
            counts = _all_reduce_data(
                torch.stack([m.sum() for m in mask.chunk(n, dim=0)])
                .to(torch.float32), mesh)
        lcfg = (dataclasses.replace(cfg, moe_groups=cfg.moe_groups // d)
                if cfg.family == "moe" else cfg)
        metrics, grads = loss_and_grads(
            full, local, cfg=lcfg, num_microbatches=n,
            denoms=list(torch.clamp(counts, min=1.0)), share=1.0 / d,
            view=view)
        keys = sorted(metrics)
        summed = _all_reduce_data(torch.stack([metrics[k] for k in keys]),
                                  mesh)
        return dict(zip(keys, summed.unbind())), grads
    return loss_and_grads(full, batch, cfg=cfg, num_microbatches=n,
                          view=view)


def _reduce_grads(whole: list, shardings, mesh, mode: str,
                  split: ModelSplit | None):
    """(this rank's shards of the gradients, the whole gradient's global
    norm) from ``whole``, the (path, gradient of the gathered leaf) list in
    ``adamw.leaves`` order, each dropped from the list once reduced: a
    leaf of ``split.summed`` summed over ``"model"``, a leaf gathered
    whole along ``"model"`` cut to the rank's block, then each summed
    (split) or averaged (global) over the data ranks, by a reduce-scatter
    along the dims they cut, else an all-reduce.  The squares of each
    shard are summed, then each sum over the axes that cut its leaves."""
    d = data_ways(mesh)
    data = [a for a in DATA_AXES if mesh.shape.get(a, 1) > 1]
    by_path = dict(_items(shardings))
    sumsq: dict[tuple[str, ...], list] = {}
    local_grads = {}
    for j, (path, g) in enumerate(whole):
        whole[j] = None                 # the gathered leaf goes once cut
        sh = by_path[path]
        gathered = _gathered_axes(mesh, split, path)
        if split is not None and path in split.summed:
            dist.all_reduce(g, group=mesh.group("model"))
        g = sh.cut(g, [a for a in gathered if a not in DATA_AXES])
        scatter = [a for a in data if a in gathered and sh.cuts(a)]
        for a in data:
            if a not in scatter:
                dist.all_reduce(g, group=mesh.group(a))
        if scatter:
            g = sh.reduce_scatter(g, scatter)
        if mode == "global" and d > 1:
            g.div_(d)
        key = tuple(a for a in mesh.shape if sh.cuts(a))
        sumsq.setdefault(key, []).append(torch.sum(torch.square(g)))
        local_grads[path] = g
        del g
    total = None
    for key in sorted(sumsq):
        part = sum(sumsq[key])
        for a in key:
            dist.all_reduce(part, group=mesh.group(a))
        total = part if total is None else total + part
    return (M.map_params(lambda path, _: local_grads.pop(path), shardings),
            torch.sqrt(total))


# ============================================================ serve steps
def prefill_step(params, batch, *, cfg: ModelConfig, max_len: int,
                 mesh=None, layout: partition.ServeLayout | None = None):
    """The prompt's forward, building decode caches sized ``max_len`` ->
    (last-token logits, caches): ``M.prefill`` on one device.

    On a rank of ``mesh`` it is GSPMD's contract, as
    :func:`sharded_train_step`'s: ``batch`` is the global batch, and the
    rank runs the rows that :func:`serve_rows` gives it; ``params`` are its
    blocks in ``layout`` (default :func:`serve_layout` at those rows),
    gathered a layer at a time inside ``partition.materialising``.  The
    logits are its rows', the caches its blocks of them."""
    if mesh is None:
        return M.prefill(params, batch, cfg, max_len=max_len)
    rows, seq = next(iter(batch.values())).shape[:2]
    sh = serve_rows(cfg, mesh, rows, seq)
    local = {k: _rows_of(v, sh) for k, v in batch.items()}
    lcfg = _rows_config(cfg, sh)
    if layout is None:
        layout = serve_layout(cfg, mesh, sh.local_shape[0], max_len)
    if layout.split is not None:
        lcfg = _rows_config(layout.split.cfg, sh)
    with partition.materialising(layout):
        logits, caches = M.prefill(params, local, lcfg, max_len=max_len)
    return logits, layout.blocks_of(caches, layout.caches)


def serve_step(params, caches, tokens, *, cfg: ModelConfig, mesh=None,
               layout: partition.ServeLayout | None = None):
    """One decode step of ``tokens`` (B,) -> (logits, caches), the caches
    advanced in place: ``M.decode_step`` on one device.  On a rank of
    ``mesh`` (see :func:`prefill_step`) ``tokens`` is the global batch's,
    the rank decodes its rows (a decode is dropless, so an MoE model's
    rows split too) and ``params`` and ``caches`` are its blocks in
    ``layout`` (default :func:`serve_layout` at those rows and the
    caches' length)."""
    if mesh is None:
        return M.decode_step(params, caches, tokens, cfg)
    sh = serve_rows(cfg, mesh, tokens.shape[0], 1, dropless=True)
    if layout is None:
        layout = serve_layout(cfg, mesh, sh.local_shape[0],
                              _cache_len(cfg, caches))
    if layout.split is not None:
        cfg = layout.split.cfg
    with partition.materialising(layout):
        return M.decode_step(params, caches, _rows_of(tokens, sh),
                             _rows_config(cfg, sh))


def serve_rows(cfg: ModelConfig, mesh, rows: int, seq_len: int, *,
               dropless: bool = False) -> partition.NamedSharding:
    """How a serving batch of ``rows`` rows of ``seq_len`` tokens lies on
    ``mesh``: cut by the batch rule as :func:`batch_shardings` cuts it
    (with its divisibility fallback: long_500k's one row is whole on every
    rank), or whole on every rank where an MoE dispatch with capacity
    spans the batch (``moe_groups`` 0, or groups the cut does not divide:
    :func:`loss_mode`'s rule), as GSPMD's one program computes it."""
    sh = partition.named_sharding(("batch",), mesh, shape=(rows,),
                                  rules=partition.scope_rules())
    ways = rows // sh.local_shape[0]
    g = cfg.moe_groups
    if ways > 1 and cfg.family == "moe" and not dropless \
            and (not g or g % ways or rows * seq_len % g):
        return partition.named_sharding((None,), mesh, shape=(rows,))
    return sh


def _rows_of(x: torch.Tensor, rows: partition.NamedSharding) -> torch.Tensor:
    """This rank's rows of ``x`` (a view) as ``rows`` cuts its dim 0."""
    return partition.NamedSharding(
        rows.mesh, partition.PartitionSpec(*rows.spec, *[None] * (x.dim() - 1)),
        tuple(x.shape)).view(x)


def _rows_config(cfg: ModelConfig, rows: partition.NamedSharding):
    """``cfg`` for a rank's rows: an MoE model's ``moe_groups`` cut by the
    ways the rows are cut, as :func:`_grads` cuts them."""
    ways = rows.shape[0] // rows.local_shape[0]
    if cfg.family != "moe" or ways == 1:
        return cfg
    return dataclasses.replace(cfg, moe_groups=cfg.moe_groups // ways)


def serve_layout(cfg: ModelConfig, mesh, rows: int,
                 max_len: int) -> partition.ServeLayout:
    """The GSPMD serving layout of a rank that runs ``rows`` rows with
    caches of ``max_len``: the params and the caches under
    ``partition.SERVE_RULES``, whose ``"batch"`` is uncut, so a layer's
    gather moves only what the head-like axes cut and never another
    rank's rows, and the serving split (:func:`model_split` with
    ``serving``)."""
    params = partition.tree_shardings(M.param_logical_axes(cfg), mesh,
                                      sds_tree=param_sds(cfg),
                                      rules=partition.SERVE_RULES)
    return partition.ServeLayout(
        params,
        partition.tree_shardings(M.cache_logical_axes(cfg), mesh,
                                 sds_tree=cache_sds(cfg, rows, max_len),
                                 rules=partition.SERVE_RULES),
        model_split(cfg, mesh, params, serving=True))


def _cache_len(cfg: ModelConfig, caches) -> int:
    """The positions the K/V caches hold (never cut: ``kv_seq`` stays
    whole); 1 for an ssm model's, which hold none."""
    kv = {"hybrid": "attn", "enc_dec": "self"}.get(cfg.family)
    if cfg.family == "ssm":
        return 1
    return (caches[kv] if kv else caches)["k"].shape[2]


# =========================================================== shape records
def _sds(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_sds(cfg: ModelConfig, shape: ShapeSpec, *,
              with_labels: bool = True) -> dict[str, torch.Tensor]:
    """Shape records (``meta`` tensors) of a train or prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out: dict[str, torch.Tensor] = {}
    if cfg.family == "enc_dec":
        out["enc_embeds"] = _sds((b, cfg.enc_len, cfg.d_model), dt)
        out["tokens"] = _sds((b, s), torch.int32)
    elif cfg.input_mode == "embeddings":
        out["embeds"] = _sds((b, s, cfg.d_model), dt)
    else:
        out["tokens"] = _sds((b, s), torch.int32)
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32)
    return out


def cache_sds(cfg: ModelConfig, batch: int, max_len: int):
    """Shape records of the decode caches, the structure of the port's
    ``M.prefill`` output exactly (an encoder-decoder's ``cross`` is a
    ``{'k', 'v'}`` dict, the reference's a tuple)."""
    dt = getattr(torch, cfg.dtype)
    kvl = M.kv_cache_len(cfg, max_len)

    def kv(layers, length):
        x = (layers, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": _sds(x, dt), "v": _sds(x, dt),
                "len": _sds((layers,), torch.int32)}

    def ssm_states(lead):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        return {"conv": _sds(lead + (batch, cfg.conv_width - 1, conv_ch), dt),
                "ssd": _sds(lead + (batch, cfg.ssm_heads, cfg.ssm_state,
                                    cfg.ssm_headdim), torch.float32)}

    if cfg.family in M.ATTENTION_FAMILIES:
        return kv(cfg.n_layers, kvl)
    if cfg.family == "ssm":
        return ssm_states((cfg.n_layers,))
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_group
        trailing = cfg.n_layers % cfg.hybrid_group
        out = {"mamba": ssm_states((n_groups, cfg.hybrid_group)),
               "attn": kv(n_groups, kvl)}
        if trailing:
            out["trailing"] = ssm_states((trailing,))
        return out
    if cfg.family == "enc_dec":
        x = (cfg.dec_layers, batch, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
        return {"self": kv(cfg.dec_layers, kvl),
                "cross": {"k": _sds(x, dt), "v": _sds(x, dt)}}
    raise ValueError(cfg.family)


def serve_param_sds(cfg: ModelConfig):
    """Shape records of the params as serving keeps them (``M.init_lm``'s
    default): the compute dtype, ``M.F32_LEAVES`` float32."""
    dt = M.compute_dtype(cfg)
    return M.map_params(
        lambda path, shape: _sds(shape, torch.float32
                                 if path[-1] in M.F32_LEAVES else dt),
        M.param_shapes(cfg))


def decode_tokens_sds(batch: int) -> torch.Tensor:
    return _sds((batch,), torch.int32)


def param_sds(cfg: ModelConfig, dtype: torch.dtype | None = None):
    """Shape records of the param tree (``cfg.param_dtype`` unless
    ``dtype``)."""
    dt = dtype or getattr(torch, cfg.param_dtype)
    return M.map_params(lambda _, shape: _sds(shape, dt), M.param_shapes(cfg))


# ------------------------------------------------------------- shardings
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "mask": ("batch", "seq"),
              "embeds": ("batch", "seq", None),
              "enc_embeds": ("batch", "seq", None)}


def batch_shardings(batch_tree, mesh, rules: dict[str, Any] | None = None):
    """The batch's NamedShardings by :data:`BATCH_AXES`; ``rules`` as in
    :func:`param_shardings`."""
    rules = partition.scope_rules(rules)
    return {k: partition.named_sharding(BATCH_AXES[k], mesh,
                                        shape=tuple(v.shape), rules=rules)
            for k, v in batch_tree.items()}


#: the reference's launch-side name of ``M.cache_logical_axes`` (the table
#: lives with the cache layouts), kept for parity with it
cache_axes = M.cache_logical_axes


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int,
                    rules: dict[str, Any] | None = None):
    """The decode caches' tree of NamedShardings; ``rules`` as in
    :func:`param_shardings`."""
    return partition.tree_shardings(M.cache_logical_axes(cfg), mesh,
                                    sds_tree=cache_sds(cfg, batch, max_len),
                                    rules=partition.scope_rules(rules))


def param_shardings(cfg: ModelConfig, mesh,
                    rules: dict[str, Any] | None = None):
    """The params' tree of NamedShardings, from ``M.param_logical_axes``
    at the params' shapes, under ``rules``, else under the innermost
    ``partition.mesh_rules`` scope's (``DEFAULT_RULES`` outside one)."""
    return partition.tree_shardings(M.param_logical_axes(cfg), mesh,
                                    sds_tree=param_sds(cfg),
                                    rules=partition.scope_rules(rules))


def opt_shardings(pshard, mesh):
    return {"mu": pshard, "nu": pshard,
            "step": partition.named_sharding((), mesh, shape=())}


# ------------------------------------------------------------ microbatching
def pick_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Default microbatch count: keep per-device live tokens bounded."""
    per_dev_tokens = shape.global_batch * shape.seq_len / data_ways(mesh)
    target = 64 * 1024                      # tokens per device per microbatch
    n = max(1, int(per_dev_tokens // target))
    while shape.global_batch % n:
        n -= 1
    return n
