"""Manual tensor parallelism for the serving path (Megatron-style), the port
of ``repro.dist.tp``.

Each rank of a 1-D ``("model",)`` mesh holds a slice of every param that
:data:`TP_RULES` maps to ``"model"``: its share of the attention heads and
kv heads and of the MLP (or expert FFN) hidden dim.  Embeddings, the vocab
projection, the router and every SSM axis stay whole on every rank.  The
model's two seams per layer, after the attention output projection and
after the MLP down projection, hold partial sums, and :func:`tp_allreduce`
sums them over the ranks.  The logits after the last seam are the same on
every rank (the lm_head is replicated), so every rank samples the same
token.

* :func:`tp_context` — a contextvar scope the engine enters around each
  model dispatch; model code stays unconditional.
* :func:`tp_allreduce` — the seam: the identity with no scope, else
  ``dist.all_reduce`` over the scope's group or, with ``compressed``,
  :func:`~repro_torch.dist.collectives.compressed_all_reduce`.
* :func:`tp_shard` — a rank's slice of a param tree, from its logical axes
  (``models.model.param_logical_axes``).
* :func:`local_config` — the config a rank's model code runs with: its
  shard's head, kv-head and hidden counts.
* :func:`tp_eligible` — the gate: manual TP sums *partial* products, so
  every seam dimension must divide the mesh exactly.

Training sharded along ``"model"`` (``launch/steps.sharded_train_step``)
enters :func:`training` instead.  There the seams are Megatron's two
autograd operators over the ``"model"`` group: :func:`tp_enter` (the
identity forward, an all-reduce of the gradient backward) where a
replicated activation enters a cut product, and :func:`tp_allreduce`
(an all-reduce forward, the identity backward) where the partial sums
leave it.  Each acts only on the seams the scope names as cut (the
rank's params are cut there; elsewhere compute is replicated and the
seams are the identity).  :func:`model_part` tells model code which part
of a cut dimension the rank holds (the expert-parallel MoE, the router,
the vocab-parallel embedding and loss), and :func:`model_max` is the
loss's max over the vocab shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import compressed_all_reduce
from repro_torch.models.config import ModelConfig

#: Serving tensor-parallel rules (1-D ``("model",)`` mesh), the reference's:
#: ``experts`` replicate (MoE routing/dispatch is replicated computation
#: under manual TP — only the expert FFN hidden dim shards), ``vocab``
#: replicates (local argmax, no masked-gather embedding), and batch/SSM
#: axes never shard.
TP_RULES: dict[str, Any] = {
    "batch": None,
    "embed": None,
    "vocab": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": None,
    "ssm_heads": None,
    "ssm_inner": None,
    "conv_ch": None,
    "act_seq": None,
    "seq": None,
    "kv_seq": None,
    "head_dim": None,
    "ssm_state": None,
    "layers": None,
    "embed_act": None,
}

#: model families the manual path covers (the attention families the
#: continuous engine's paged mode already serves)
TP_FAMILIES = ("dense", "moe", "vlm")


#: the seams a training scope may cut (``training``): attention heads,
#: the dense or expert MLP's hidden dim, the experts (expert-parallel FFN),
#: the MoE router's expert columns, and the vocab (embedding rows and
#: lm_head columns)
TRAIN_SEAMS = ("attn", "mlp", "experts", "router", "vocab")


@dataclasses.dataclass(frozen=True)
class _Scope:
    group: Any
    compressed: bool = False
    block: int = 64
    train: bool = False
    rank: int = 0
    n: int = 1
    cut: frozenset = frozenset()


_TP: contextvars.ContextVar[_Scope | None] = \
    contextvars.ContextVar("repro_torch_dist_tp", default=None)
#: seam reductions this process has run (exact and compressed): a model
#: dispatch under a scope runs two a layer
seams = 0


@contextlib.contextmanager
def tp_context(group, *, compressed: bool = False,
               block: int = 64) -> Iterator[None]:
    """Activate the TP seams over process group ``group``.  With
    ``compressed`` the seams reduce through ``compressed_all_reduce`` (int8
    payloads, bounded per-block error); callers wanting exact parity leave
    it off."""
    token = _TP.set(_Scope(group, compressed, block))
    try:
        yield
    finally:
        _TP.reset(token)


@contextlib.contextmanager
def training(group, rank: int, n: int, cut) -> Iterator[None]:
    """Activate the training seams over ``group``, the ``"model"`` group
    in which this rank is ``rank`` of ``n``: each seam named in ``cut`` (of
    :data:`TRAIN_SEAMS`) is an autograd operator, every other the
    identity.  A seam that finds no group raises."""
    if group is None:
        raise ValueError("training seams need the 'model' process group")
    bad = set(cut) - set(TRAIN_SEAMS)
    if bad:
        raise ValueError(f"unknown seams {sorted(bad)}")
    token = _TP.set(_Scope(group, train=True, rank=rank, n=n,
                           cut=frozenset(cut)))
    try:
        yield
    finally:
        _TP.reset(token)


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient all-reduced over the group
    backward (each rank's is its cut product's partial)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums all-reduced over the group forward; the identity
    backward (every rank's gradient of the sum is the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _train_seam(seam: str) -> _Scope | None:
    """The training scope when it cuts ``seam``, else None."""
    scope = _TP.get()
    if scope is None or not scope.train or seam not in scope.cut:
        return None
    return scope


def tp_enter(x: torch.Tensor, seam: str) -> torch.Tensor:
    """Where replicated ``x`` enters the cut products of ``seam``: under a
    training scope that cuts it, the identity whose backward all-reduces
    the gradient over ``"model"``; else ``x`` itself."""
    scope = _train_seam(seam)
    return x if scope is None else _CopyToModel.apply(x, scope.group)


def model_part(seam: str) -> tuple[int, int] | None:
    """(this rank's index, the ranks) along ``"model"`` under a training
    scope that cuts ``seam``, else None."""
    scope = _train_seam(seam)
    return None if scope is None else (scope.rank, scope.n)


def model_max(x: torch.Tensor, seam: str) -> torch.Tensor:
    """The elementwise max of ``x`` over the ``"model"`` ranks of a
    training scope that cuts ``seam`` (no gradient), else ``x``."""
    scope = _train_seam(seam)
    if scope is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=scope.group)
    return out


def tp_allreduce(x: torch.Tensor, seam: str = "attn") -> torch.Tensor:
    """Sum ``x``'s partial products over the TP group (the identity when no
    TP scope is active).  The one primitive model code calls, placed right
    after every contraction over a sharded dimension.  Under a training
    scope it is the autograd seam of ``seam`` (the identity where the
    scope does not cut it); a serving scope cuts every seam."""
    global seams
    scope = _TP.get()
    if scope is None:
        return x
    if scope.train:
        if seam not in scope.cut:
            return x
        seams += 1
        return _ReduceFromModel.apply(x, scope.group)
    seams += 1
    if scope.compressed:
        return compressed_all_reduce(x, scope.group, block=scope.block)
    # all_reduce needs a dense tensor; a product's output already is one
    x = x.contiguous()
    dist.all_reduce(x, group=scope.group)
    return x


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shard_dim(axes: tuple) -> int | None:
    """The dimension of a leaf with logical ``axes`` that shards over
    ``"model"`` under :data:`TP_RULES`, or None when it is replicated."""
    dims = [i for i, a in enumerate(axes) if TP_RULES.get(a) == "model"]
    if len(dims) > 1:
        raise ValueError(f"axes {axes} shard more than one dim over 'model'")
    return dims[0] if dims else None


def tp_shard(tree, axes_tree, rank: int, n: int):
    """Rank ``rank``'s slice (of ``n``) of every leaf of ``tree``, cut on
    the dimension its logical axes map to ``"model"`` (a contiguous copy);
    replicated leaves are returned as they are.

    No divisibility fallback on purpose: :func:`tp_eligible` guarantees
    every seam dimension divides the mesh, and a silent replication here
    would corrupt the partial sums."""
    if isinstance(tree, dict):
        return {k: tp_shard(v, axes_tree[k], rank, n)
                for k, v in tree.items()}
    if not _is_axes_leaf(axes_tree) or len(axes_tree) != tree.dim():
        raise ValueError(f"axes {axes_tree} do not describe a leaf of shape "
                         f"{tuple(tree.shape)}")
    dim = shard_dim(axes_tree)
    if dim is None:
        return tree
    size = tree.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of shape {tuple(tree.shape)} does not "
                         f"divide {n} shards")
    part = size // n
    return tree.narrow(dim, rank * part, part).contiguous()


def local_config(cfg: ModelConfig, n: int) -> ModelConfig:
    """The config one of ``n`` ranks runs: its shard's ``n_heads``,
    ``n_kv_heads`` and ``d_ff`` (an MoE's per-expert hidden dim), with
    ``head_dim`` pinned so it does not follow the smaller head count."""
    ok, reason = tp_eligible(cfg, n)
    if not ok:
        raise ValueError(f"{cfg.name} cannot shard {n} ways: {reason}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // n,
                               n_kv_heads=cfg.n_kv_heads // n,
                               d_ff=cfg.d_ff // n, head_dim=cfg.hd)


def tp_eligible(cfg: ModelConfig, n_shards: int) -> tuple[bool, str]:
    """Can ``cfg`` run the manual TP path over ``n_shards``?

    Returns ``(ok, reason)``; the reason names the first disqualifier.  The
    divisibility checks are load-bearing, not a preference: a seam
    dimension that does not divide the mesh could not be cut evenly, and
    ``tp_allreduce`` would sum the wrong partial products.
    """
    if n_shards <= 1:
        return False, "mesh has no model-parallel extent"
    if cfg.family not in TP_FAMILIES:
        return False, (f"family {cfg.family!r} not in {TP_FAMILIES} "
                       f"(dense per-slot SSM/cross state)")
    if cfg.padded_heads:
        return False, ("padded_heads uses a q->kv head map built from "
                       "global head counts")
    for name, dim in (("n_heads", cfg.n_heads), ("n_kv_heads",
                                                 cfg.n_kv_heads),
                      ("d_ff", cfg.d_ff)):
        if dim % n_shards:
            return False, f"{name}={dim} not divisible by {n_shards} shards"
    return True, "ok"
