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

Serving on the GSPMD path (``serve/engine.py``) keeps each rank's blocks
of the params and caches under :data:`SERVE_RULES` (a
:class:`ServeLayout`) and runs the model inside :func:`materialising`:
the model's layer loops call :func:`whole` and :func:`whole_cache` on
what a layer reads, :func:`take` for an embedding lookup and
:func:`write_back` for the caches a layer wrote, so a rank gathers one
layer at a time and computes what one device computes.
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

    def block(self, entry) -> int:
        """This rank's block index along a dimension cut by ``entry``."""
        block = 0
        for a in _names(entry):
            block = block * self.mesh.shape[a] + self.mesh.coord(a)
        return block

    def view(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a tensor of :attr:`shape`) as a
        view of it; ``full`` itself when nothing cuts it."""
        if self.shape is not None and tuple(full.shape) != self.shape:
            raise ValueError(f"a tensor of {tuple(full.shape)} is not the "
                             f"{self.shape} this sharding lays out")
        out = full
        for dim, entry in enumerate(self.spec):
            ways = self._ways(entry)
            if ways > 1:
                size = full.shape[dim] // ways
                out = out.narrow(dim, self.block(entry) * size, size)
        return out

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a tensor of :attr:`shape`): a new
        tensor of its own, or ``full`` itself when nothing cuts it."""
        out = self.view(full)
        return full if self.replicated else out.clone()

    def inner(self, ndim: int) -> "NamedSharding":
        """The sharding of one ``ndim``-dimensional slice of the tensor
        along its leading dimensions (a layer of a stacked leaf), which
        must not be cut."""
        k = len(self.shape) - ndim
        if k == 0:
            return self
        if k < 0 or any(self._ways(e) > 1 for e in self.spec[:k]):
            raise ValueError(f"{ndim} trailing dims of {self.spec} over "
                             f"{self.shape} are not a slice along uncut "
                             f"leading dims")
        return NamedSharding(self.mesh, PartitionSpec(*self.spec[k:]),
                             self.shape[k:])

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


def blocks_zeros(tree: Any, shardings: Any, device) -> Any:
    """Zeros of this rank's block shape for every leaf of ``tree`` (whole
    tensors, or meta tensors that only give shapes and dtypes)."""
    return _zip_map(lambda sh, t: torch.zeros(sh.local_shape, dtype=t.dtype,
                                              device=device), tree, shardings)


# ------------------------------------------------------------ serving layout
@dataclasses.dataclass
class ServeLayout:
    """The state of a serving rank at rest, laid out as the reference's
    GSPMD path lays it out: the :class:`NamedSharding` of every param leaf
    (``params``) and of every serving-cache leaf (``caches``), whose
    blocks are all the rank keeps.  ``gathered_bytes`` counts the whole
    tensors its dispatches have gathered."""

    params: Any
    caches: Any
    gathered_bytes: int = 0

    def gather(self, tree: Any, shardings: Any) -> Any:
        """A tree of this rank's blocks (whole leaves, or one layer's
        slices of stacked ones) gathered whole, leaf by leaf; an uncut
        leaf is returned as it is."""
        if isinstance(tree, dict):
            return {k: self.gather(v, shardings[k]) for k, v in tree.items()}
        sh = shardings.inner(tree.dim())
        if sh.replicated:
            return tree
        out = sh.gather(tree)
        self.gathered_bytes += out.numel() * out.element_size()
        return out


_LAYOUT: contextvars.ContextVar[ServeLayout | None] = \
    contextvars.ContextVar("repro_torch_dist_serve_layout", default=None)


@contextlib.contextmanager
def materialising(layout: ServeLayout) -> Iterator[ServeLayout]:
    """Run model code on a serving rank whose state is ``layout``'s blocks:
    inside, :func:`whole`, :func:`whole_cache` and :func:`take` gather what
    a layer reads just before it runs, and :func:`write_back` keeps the
    rank's block of what it wrote.  Outside, all four are the identity (or
    a plain copy), so one-device paths pay one context lookup a layer."""
    token = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(token)


def _at(tree: Any, path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def whole(tree: Any, *path: str) -> Any:
    """The params at ``path`` of the param tree (a leaf, a subtree, or one
    layer's view of stacked leaves), whole: gathered inside a
    :func:`materialising` scope, ``tree`` itself outside one."""
    layout = _LAYOUT.get()
    if layout is None:
        return tree
    return layout.gather(tree, _at(layout.params, path))


def whole_cache(tree: Any, *path: str) -> Any:
    """:func:`whole` for the serving caches: ``tree`` holds some leaves of
    the cache subtree at ``path`` (one layer's slices, say)."""
    layout = _LAYOUT.get()
    if layout is None:
        return tree
    return layout.gather(tree, _at(layout.caches, path))


def write_back(view: dict, new: dict, *path: str) -> None:
    """Store ``new`` (the leaves a layer wrote: whole inside a
    :func:`materialising` scope) into the resident cache slices ``view``
    of the subtree at ``path``: this rank's block of each, in place; a
    leaf that is its view's own tensor (written in place already) is
    skipped."""
    layout = _LAYOUT.get()
    shardings = None if layout is None else _at(layout.caches, path)
    for k, v in view.items():
        n = new[k]
        if n is v:
            continue
        if shardings is not None:
            n = shardings[k].inner(n.dim()).view(n)
        v.copy_(n)


def take(table: torch.Tensor, ids: torch.Tensor, *path: str) -> torch.Tensor:
    """``whole(table, *path)[ids]`` (an embedding lookup) without the whole
    table: each rank looks its own rows up, the lookups are gathered, and
    each id takes its owner's row, so only the rows ``ids`` name cross the
    ranks.  A table cut past its row dimension is gathered whole."""
    layout = _LAYOUT.get()
    if layout is None:
        return table[ids]
    sh = _at(layout.params, path)
    if sh.replicated:
        return table[ids]
    if any(sh._ways(e) > 1 for e in sh.spec[1:]):
        return layout.gather(table, sh)[ids]
    rows, ways = table.shape[0], sh._ways(sh.spec[0])
    mine = table[(ids - sh.block(sh.spec[0]) * rows).clamp(0, rows - 1)]
    every = NamedSharding(sh.mesh, PartitionSpec(sh.spec[0]),
                          (ways,) + tuple(mine.shape)).gather(mine[None])
    layout.gathered_bytes += every.numel() * every.element_size()
    owner = (ids // rows)[None, ..., None].expand((1,) + tuple(mine.shape))
    return torch.take_along_dim(every, owner, dim=0)[0]


# ---------------------------------------------------------------- constraint
def shard(x, *axes: str | None):
    """Constrain activation ``x`` to its logical axes' sharding: the
    identity, returning ``x`` itself.  The reference's constraint tells
    GSPMD how to lay out a global array; here every rank's activations
    already are its own local slice (its rows of the batch, whole along
    ``"model"``), so there is nothing to move."""
    return x
