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


@dataclasses.dataclass(frozen=True)
class _Scope:
    group: Any
    compressed: bool
    block: int


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


def tp_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x``'s partial products over the TP group (the identity when no
    TP scope is active).  The one primitive model code calls, placed right
    after every contraction over a sharded dimension."""
    global seams
    scope = _TP.get()
    if scope is None:
        return x
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
