"""Logical-axis sharding rules (the port of ``repro/dist/partition.py``).

Model code names the *logical* meaning of every tensor dimension ("batch",
"embed", "mlp", ...); this module resolves those names to *mesh* axes
("pod", "data", "model") under a rule table, with the reference's three
rules:

* mesh axes absent from the mesh are dropped ("pod" on a one-pod mesh);
* a mesh axis is used at most once within one spec (no reuse);
* a dimension is sharded only if its size divides the product of the mesh
  axes assigned to it; otherwise axes are dropped innermost-first until it
  does (divisibility fallback), down to replication.

Where the reference hands a spec to GSPMD, which lays the shards out, here
every rank is a process holding plain local tensors, so a
:class:`NamedSharding` does the layout itself, as GSPMD does it: a
dimension mapped to axes ``(a, b)`` is cut into ``size(a) * size(b)``
equal blocks and the rank at coordinates ``(i, j)`` holds block ``i *
size(b) + j``.  :meth:`NamedSharding.local` cuts a rank's block out of a
full tensor and :meth:`NamedSharding.gather` rebuilds the full tensor from
the blocks with an all-gather over each axis's group
(``launch/mesh.py``), innermost axis first.  The rules are data, not code:
a :func:`mesh_rules` scope overrides them for the state that
``launch/steps.py`` lays out (``{"embed": None}`` keeps the params whole
along ``"data"``).  Activations are not laid out by rules (:func:`shard`
is the identity), so their axes' rules ("act_seq", "embed_act") change
nothing here.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist

# Logical axis -> mesh axis (or tuple of mesh axes, outermost first).
# ``None`` documents an axis that deliberately stays replicated/unsharded.
DEFAULT_RULES: dict[str, Any] = {
    # data-parallel axes
    "batch": ("pod", "data"),          # global batch over pod x data
    # fully-sharded (ZeRO/FSDP-style) parameter embed dim
    "embed": "data",
    # tensor/expert-parallel axes
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "conv_ch": "model",
    # sequence parallelism: activations' seq dim when cfg.seq_shard is on
    "act_seq": "model",
    # replicated-by-default axes
    "seq": None,                       # input token dim (SP: "model")
    "kv_seq": None,                    # decode-cache length
    "head_dim": None,
    "ssm_state": None,
    "layers": None,                    # stacked layer dim
    "embed_act": None,                 # activations' embed dim (residual)
}

#: serving rules: DEFAULT_RULES with the batch axis replicated (the
#: continuous engine's cache "batch" dim is the slot or page axis, spliced
#: per request; sharding it would turn every insert into cross-rank
#: traffic).  The head-like axes keep their "model" mapping.
SERVE_RULES: dict[str, Any] = {**DEFAULT_RULES, "batch": None}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of mesh axis names (outermost first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# --------------------------------------------------------------- active mesh
# contextvar (not a module global): concurrent mesh_rules scopes in different
# threads must not see each other's mesh
_ACTIVE: contextvars.ContextVar[tuple[tuple[Any, dict[str, Any]], ...]] = \
    contextvars.ContextVar("repro_torch_dist_mesh_rules", default=())


@contextlib.contextmanager
def mesh_rules(mesh, rules: dict[str, Any] | None = None) -> Iterator[Any]:
    """Activate ``mesh`` (+ optional rule overrides, merged over
    :data:`DEFAULT_RULES`) for a region of code: the sharding helpers of
    ``launch/steps.py`` (and so ``train``'s state, its checkpoints and
    their restores) lay tensors out by the scope's rules
    (:func:`scope_rules`).  Reentrant; innermost wins."""
    entry = (mesh, {**DEFAULT_RULES, **(rules or {})})
    token = _ACTIVE.set(_ACTIVE.get() + (entry,))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh_rules() -> tuple[Any, dict[str, Any] | None]:
    """(mesh, rules) of the innermost ``mesh_rules`` scope, or (None, None)."""
    stack = _ACTIVE.get()
    return stack[-1] if stack else (None, None)


def scope_rules(rules: dict[str, Any] | None = None) -> dict[str, Any] | None:
    """``rules`` if given, else the innermost ``mesh_rules`` scope's (None,
    meaning :data:`DEFAULT_RULES`, outside any): the rules that the
    sharding helpers of ``launch/steps.py`` lay state and batches out by."""
    return rules if rules is not None else active_mesh_rules()[1]


# ---------------------------------------------------------------- resolution
def resolve_spec(axes: Sequence[str | None], mesh,
                 shape: Sequence[int] | None = None,
                 rules: dict[str, Any] | None = None) -> PartitionSpec:
    """Logical axes -> :class:`PartitionSpec` for ``mesh`` (anything with a
    ``shape`` mapping of axis name to size).

    Mesh axes absent from ``mesh`` are dropped; a mesh axis already consumed
    by an earlier dimension of this spec is skipped; with ``shape``,
    assigned axes are dropped innermost-first until the dimension size
    divides their product.
    """
    rules = DEFAULT_RULES if rules is None else rules
    sizes = dict(mesh.shape)
    used: set[str] = set()
    entries: list[Any] = []
    for i, logical in enumerate(axes):
        target = rules.get(logical) if logical is not None else None
        if target is None:
            entries.append(None)
            continue
        cand = (target,) if isinstance(target, str) else tuple(target)
        chosen = [a for a in cand if a in sizes and a not in used]
        if shape is not None:
            while chosen and shape[i] % math.prod(sizes[a] for a in chosen):
                chosen.pop()
        if not chosen:
            entries.append(None)
            continue
        used.update(chosen)
        entries.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
    return PartitionSpec(*entries)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How one tensor of global ``shape`` lies on ``mesh`` (this rank's view
    of it): ``spec`` says which mesh axes cut each dimension.  ``shape``
    is None where it was built without one (``named_sharding`` with no
    shape, for a spec alone)."""

    mesh: Any
    spec: PartitionSpec
    shape: tuple[int, ...] | None

    def _ways(self, entry) -> int:
        return math.prod(self.mesh.shape[a] for a in _names(entry))

    @property
    def replicated(self) -> bool:
        return all(self._ways(e) == 1 for e in self.spec)

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // self._ways(e) for n, e in zip(self.shape, self.spec))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a tensor of :attr:`shape`): a new
        tensor of its own, or ``full`` itself when nothing cuts it."""
        if self.shape is not None and tuple(full.shape) != self.shape:
            raise ValueError(f"a tensor of {tuple(full.shape)} is not the "
                             f"{self.shape} this sharding lays out")
        if self.replicated:
            return full
        out = full
        for dim, entry in enumerate(self.spec):
            ways = self._ways(entry)
            if ways == 1:
                continue
            block = 0
            for a in _names(entry):
                block = block * self.mesh.shape[a] + self.mesh.coord(a)
            size = full.shape[dim] // ways
            out = out.narrow(dim, block * size, size)
        return out.clone()

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (``shard`` is this
        rank's): an all-gather over each cutting axis's group, innermost
        first.  Every rank of each group must call it; ``shard`` itself
        when nothing cuts it."""
        out = shard
        for dim, entry in enumerate(self.spec):
            for a in reversed(_names(entry)):
                n = self.mesh.shape[a]
                if n == 1:
                    continue
                parts = [torch.empty_like(out) for _ in range(n)]
                dist.all_gather(parts, out.contiguous(),
                                group=self.mesh.group(a))
                out = torch.cat(parts, dim=dim)
        return out


def named_sharding(axes: Sequence[str | None], mesh,
                   shape: Sequence[int] | None = None,
                   rules: dict[str, Any] | None = None) -> NamedSharding:
    """The :class:`NamedSharding` of one tensor's logical axes on ``mesh``;
    without ``shape``, no divisibility fallback."""
    spec = resolve_spec(axes, mesh, shape=shape, rules=rules)
    return NamedSharding(mesh, spec, None if shape is None else tuple(shape))


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(axes_tree: Any, mesh, *, sds_tree: Any = None,
                   rules: dict[str, Any] | None = None) -> Any:
    """A nested dict of logical-axes tuples -> the same tree of
    :class:`NamedSharding`.  ``sds_tree`` (same structure; anything with a
    ``shape`` at each leaf) gives each leaf's shape and so the divisibility
    fallback."""
    if _is_axes_leaf(axes_tree):
        shape = None if sds_tree is None else tuple(sds_tree.shape)
        return named_sharding(axes_tree, mesh, shape=shape, rules=rules)
    return {k: tree_shardings(v, mesh, rules=rules,
                              sds_tree=None if sds_tree is None
                              else sds_tree[k])
            for k, v in axes_tree.items()}


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    return fn(shardings, tree)


def local_tree(tree: Any, shardings: Any) -> Any:
    """This rank's block of every leaf of a nested dict of whole tensors
    (``shardings``: the matching tree of :class:`NamedSharding`)."""
    return _zip_map(lambda sh, t: sh.local(t), tree, shardings)


def gather_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf of this rank's tree of blocks gathered whole, leaf by leaf
    (every rank of the mesh calls it)."""
    return _zip_map(lambda sh, t: sh.gather(t), tree, shardings)


# ---------------------------------------------------------------- constraint
def shard(x, *axes: str | None):
    """Constrain activation ``x`` to its logical axes' sharding: the
    identity, returning ``x`` itself.  The reference's constraint tells
    GSPMD how to lay out a global array; here every rank's activations
    already are its own local slice (its rows of the batch, whole along
    ``"model"``), so there is nothing to move."""
    return x
