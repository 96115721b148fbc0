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
what a layer reads, :func:`take` for an embedding lookup,
:func:`by_columns` for the logits and :func:`write_back` for the
caches a layer wrote, so a rank gathers one layer at a time and computes
what one device computes.  Where the layout carries a split
(``launch/steps.model_split``: an SSM mixer's heads, a hybrid's shared
attention and MLP, an enc-dec's attention and MLPs) the rank computes
with its blocks of the leaves the split cuts instead of gathering them.

Two leaves of an SSM mixer are not cut at head boundaries: ``in_proj``'s
concatenated ``[z | x | B | C | dt]`` columns and the conv's ``[x | B |
C]`` channels lie in contiguous blocks.  :func:`relay` re-lays such a
block into the columns a rank's heads read (one all-to-all along
``"model"``; every rank reads ``B`` and ``C``, so each of their columns
goes to every rank), and :func:`relay_back` lays a head-aligned result
(the conv state) back into the blocks at rest.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist import tp
from repro_torch.dist.collectives import settled

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

    def cuts(self, axis: str) -> bool:
        """Whether mesh axis ``axis`` (of more than one rank) cuts the
        tensor."""
        return self.mesh.shape.get(axis, 1) > 1 and any(
            axis in _names(e) for e in self.spec)

    def _dims(self, axes: Sequence[str] | None):
        """(dim, mesh axis) of each cutting axis in ``axes`` (None: every
        axis), innermost first within a dim.  Raises where a dim is cut by
        an axis outside ``axes`` inside one of ``axes``: the blocks along
        the outer axis alone would not be contiguous."""
        out = []
        for dim, entry in enumerate(self.spec):
            names = [a for a in _names(entry) if self.mesh.shape[a] > 1]
            mine = [a for a in names if axes is None or a in axes]
            if mine != names[len(names) - len(mine):]:
                raise ValueError(f"{self.spec} cuts dim {dim} by {names}: "
                                 f"{mine} alone are not its inner axes")
            out.extend((dim, a) for a in reversed(mine))
        return out

    def gather(self, shard: torch.Tensor,
               axes: Sequence[str] | None = None) -> torch.Tensor:
        """The full tensor from every rank's block (``shard`` is this
        rank's): an all-gather over each cutting axis's group, innermost
        first.  ``axes`` gathers over those mesh axes only (the block
        along the others, whole along these).  Every rank of each group
        must call it; ``shard`` itself when nothing cuts it."""
        out = shard
        for dim, a in self._dims(axes):
            parts = [torch.empty_like(out) for _ in range(self.mesh.shape[a])]
            mine = out.contiguous()
            settled(lambda: dist.all_gather(parts, mine,
                                            group=self.mesh.group(a)),
                    mine, *parts)
            out = torch.cat(parts, dim=dim)
        return out

    def reduce_scatter(self, t: torch.Tensor,
                       axes: Sequence[str]) -> torch.Tensor:
        """This rank's block, along the mesh axes ``axes`` that cut the
        tensor, of ``t`` summed over those axes' ranks: ``t`` is whole
        along them, and a reduce-scatter runs over each one's group,
        outermost first.  Every rank of each group must call it."""
        out = t
        for dim, a in reversed(self._dims(axes)):
            n = self.mesh.shape[a]
            mine = torch.empty_like(out.narrow(dim, 0, out.shape[dim] // n),
                                    memory_format=torch.contiguous_format)
            chunks = [c.contiguous() for c in out.chunk(n, dim=dim)]
            settled(lambda: dist.reduce_scatter(mine, chunks,
                                                group=self.mesh.group(a)),
                    mine, *chunks)
            out = mine
        return out

    def cut(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """This rank's block of ``t``, whole along the mesh axes ``axes``,
        along those of them that cut the tensor (a tensor of its own)."""
        out = t
        for dim, a in reversed(self._dims(axes)):
            size = out.shape[dim] // self.mesh.shape[a]
            out = out.narrow(dim, self.mesh.coord(a) * size, size)
        return t if out is t else out.clone()


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
    blocks are all the rank keeps.  ``split`` (a
    ``launch.steps.ModelSplit``, or None) is how its dispatches split the
    compute along ``"model"``: a leaf that ``"model"`` cuts and the split
    does not gather whole (``split.whole``) is gathered over the other
    axes only, and the caches under ``split.caches`` are computed as the
    rank's blocks.  ``gathered_bytes`` counts what its dispatches'
    collectives assembled: the whole tensors gathered, the logits'
    columns, the re-laid columns received."""

    params: Any
    caches: Any
    split: Any = None
    gathered_bytes: int = 0

    @property
    def mesh(self):
        tree = self.params
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree.mesh

    def gather(self, tree: Any, shardings: Any,
               path: tuple[str, ...] | None = None) -> Any:
        """A tree of this rank's blocks (whole leaves, or one layer's
        slices of stacked ones) gathered whole, leaf by leaf; given the
        ``path`` of the params it lies at, a leaf the split computes with
        over the axes but ``"model"`` only.  An uncut leaf is returned as
        it is."""
        if isinstance(tree, dict):
            return {k: self.gather(v, shardings[k],
                                   None if path is None else path + (k,))
                    for k, v in tree.items()}
        sh = shardings.inner(tree.dim())
        if sh.replicated:
            return tree
        axes = None
        if path is not None and self.split is not None \
                and sh.cuts("model") and path not in self.split.whole:
            axes = [a for a in sh.mesh.shape if a != "model"]
        out = sh.gather(tree, axes)
        if out is not tree:
            self.gathered_bytes += out.numel() * out.element_size()
        return out

    def splits_caches(self, path: tuple[str, ...]) -> bool:
        """Whether the split computes the caches at ``path`` as the rank's
        blocks (no gather, no cut)."""
        return self.split is not None and path in self.split.caches

    def blocks_of(self, caches: Any, shardings: Any) -> Any:
        """This rank's blocks of the caches a prefill returned
        (``shardings``: theirs): cut from whole leaves, except under the
        paths the split computes, which are blocks already."""
        if self.splits_caches(()):
            return caches
        return {k: v if self.splits_caches((k,))
                else local_tree(v, shardings[k]) for k, v in caches.items()}


_LAYOUT: contextvars.ContextVar[ServeLayout | None] = \
    contextvars.ContextVar("repro_torch_dist_serve_layout", default=None)


@contextlib.contextmanager
def materialising(layout: ServeLayout) -> Iterator[ServeLayout]:
    """Run model code on a serving rank whose state is ``layout``'s blocks:
    inside, :func:`whole`, :func:`whole_cache` and :func:`take` gather what
    a layer reads just before it runs, :func:`by_columns` the logits,
    and :func:`write_back` keeps the rank's block of what it wrote; with a
    split, its seams are active (``dist.tp.training`` over ``"model"``).
    Outside, the hooks are the identity (or a plain copy), so one-device
    paths pay one context lookup a layer."""
    token = _LAYOUT.set(layout)
    try:
        if layout.split is None:
            yield layout
        else:
            mesh = layout.mesh
            with tp.training(mesh.group("model"), mesh.coord("model"),
                             mesh.shape["model"], layout.split.cut):
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
    :func:`materialising` scope (a leaf its split computes with, over the
    axes but ``"model"`` only), ``tree`` itself outside one."""
    layout = _LAYOUT.get()
    if layout is None:
        return tree
    return layout.gather(tree, _at(layout.params, path), path)


def whole_cache(tree: Any, *path: str) -> Any:
    """:func:`whole` for the serving caches: ``tree`` holds some leaves of
    the cache subtree at ``path`` (one layer's slices, say); ``tree``
    itself where the layout's split computes them as blocks."""
    layout = _LAYOUT.get()
    if layout is None or layout.splits_caches(path):
        return tree
    return layout.gather(tree, _at(layout.caches, path))


def write_back(view: dict, new: dict, *path: str) -> None:
    """Store ``new`` (the leaves a layer wrote: whole inside a
    :func:`materialising` scope, or the rank's blocks where its split
    computes them) into the resident cache slices ``view`` of the subtree
    at ``path``: this rank's block of each, in place; a leaf that is its
    view's own tensor (written in place already) is skipped."""
    layout = _LAYOUT.get()
    shardings = None if layout is None or layout.splits_caches(path) \
        else _at(layout.caches, path)
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


def by_columns(fn, leaf: torch.Tensor, *path: str) -> torch.Tensor:
    """``fn(leaf)`` for a product whose columns are the last dimension of
    the param leaf at ``path`` (the logits of ``lm_head``): inside a
    :func:`materialising` scope whose layout cuts that dimension by
    ``"model"`` alone, ``fn`` of the rank's column block (gathered over the
    other axes) with its result's columns gathered along ``"model"``; else
    ``fn`` of :func:`whole`."""
    layout = _LAYOUT.get()
    if layout is None:
        return fn(leaf)
    sh = _at(layout.params, path)
    entry = sh.spec[-1]
    if not sh.cuts("model") or _names(entry) != ("model",):
        return fn(whole(leaf, *path))
    mine = sh.gather(leaf, [a for a in sh.mesh.shape if a != "model"])
    if mine is not leaf:
        layout.gathered_bytes += mine.numel() * mine.element_size()
    out = fn(mine)
    every = NamedSharding(
        sh.mesh, PartitionSpec(*[None] * (out.dim() - 1), entry),
        tuple(out.shape[:-1]) + (out.shape[-1] * sh._ways(entry),)
    ).gather(out)
    layout.gathered_bytes += every.numel() * every.element_size()
    return every


# ------------------------------------------------------------------ re-lay
def _clip(ranges, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in ranges
            if max(a, lo) < min(b, hi)]


def _idx(ranges, offset: int = 0) -> tuple[int, ...]:
    return tuple(i - offset for a, b in ranges for i in range(a, b))


def _index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as a long tensor on ``device`` (made at every call: a
    tensor kept across calls could outlive the fake mode of a dry run)."""
    return torch.tensor(values, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=256)
def _relay_plan(size: int, need: tuple, rank: int, n: int):
    """How rank ``rank`` of ``n`` re-lays its contiguous block of a
    dimension of ``size`` into the columns ``need[rank]`` (sorted disjoint
    ranges; ``need`` holds every rank's), each column coming from the
    rank whose block holds it: (the positions in its block it sends each
    rank, flattened; how many it sends each; how many it receives from
    each; the positions in its block of its own columns it holds)."""
    part = size // n
    lo = rank * part
    send = [() if q == rank else _idx(_clip(need[q], lo, lo + part), lo)
            for q in range(n)]
    recv = tuple(0 if s == rank else
                 len(_idx(_clip(need[rank], s * part, (s + 1) * part)))
                 for s in range(n))
    return (sum(send, ()), tuple(map(len, send)), recv,
            _idx(_clip(need[rank], lo, lo + part), lo))


def _exchange(rows: torch.Tensor, sizes_in, sizes_out, group):
    """``all_to_all_single`` along dim 0 of ``rows`` -> the rows received
    (counted in the active layout's ``gathered_bytes``)."""
    send = rows.contiguous()
    out = rows.new_empty((sum(sizes_out),) + tuple(rows.shape[1:]))
    settled(lambda: dist.all_to_all_single(
        out, send, list(sizes_out), list(sizes_in), group=group), send, out)
    layout = _LAYOUT.get()
    if layout is not None:
        layout.gathered_bytes += out.numel() * out.element_size()
    return out


class _Relay(torch.autograd.Function):
    """:func:`relay` of a block, along dim 0: forward, the columns each
    rank needs from this rank's block sent to it, and this rank's
    assembled in ``need`` order; backward, each received column's
    gradient sent back to the rank whose block holds it and summed there
    (a ``B``/``C`` column's over every rank that read it)."""

    @staticmethod
    def forward(ctx, t, plan, group, rank):
        send, n_send, recv, keep = plan
        ctx.plan, ctx.group, ctx.rank, ctx.rows = plan, group, rank, \
            t.shape[0]
        got = _exchange(t.index_select(0, _index(send, t.device)), n_send,
                        recv, group).split(recv)
        mine = t.index_select(0, _index(keep, t.device))
        return torch.cat([mine if s == rank else got[s]
                          for s in range(len(recv))])

    @staticmethod
    def backward(ctx, grad):
        send, n_send, recv, keep = ctx.plan
        sizes = [len(keep) if s == ctx.rank else r
                 for s, r in enumerate(recv)]
        parts = grad.split(sizes)
        back = _exchange(torch.cat([p for s, p in enumerate(parts)
                                    if s != ctx.rank]), recv, n_send,
                         ctx.group)
        out = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        out.index_add_(0, _index(send, grad.device), back)
        out.index_add_(0, _index(keep, grad.device), parts[ctx.rank])
        return out, None, None, None


def relay(t: torch.Tensor, dim: int, size: int, need: tuple, rank: int,
          n: int, group) -> torch.Tensor:
    """The columns ``need[rank]`` (sorted disjoint ``(start, stop)``
    ranges of a dimension of ``size``; ``need`` holds every rank's) of a
    leaf of which this rank holds ``t``: its contiguous block of ``size /
    n`` along ``dim``, or the whole of it.  A block is re-laid by one
    all-to-all over ``group`` (differentiable: see :class:`_Relay`); the
    whole of it is sliced."""
    if t.shape[dim] == size:
        return t.index_select(dim, _index(_idx(need[rank]), t.device))
    if t.shape[dim] * n != size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is neither {size} "
                         f"nor its block over {n} ranks")
    return _Relay.apply(t.movedim(dim, 0), _relay_plan(size, need, rank, n),
                        group, rank).movedim(0, dim)


@functools.lru_cache(maxsize=256)
def _relay_back_plan(size: int, need: tuple, rank: int, n: int,
                     blocked: bool):
    """How rank ``rank`` lays its ``need[rank]`` columns back into its
    block (``blocked``) or the whole dimension: a column it read comes
    from itself, every other from the one rank that read it: (the
    positions in its columns it sends each rank, flattened; how many it
    sends each; the positions in its block the ranks' columns fill,
    flattened; how many from each; the positions in its columns and in
    its block of those it keeps)."""
    part = size // n if blocked else size
    lo = rank * part if blocked else 0
    mine = _idx(need[rank])
    at = {c: i for i, c in enumerate(mine)}
    send, fill = [], []
    for q in range(n):
        theirs = () if q == rank else _idx(need[q])
        read = set(theirs)
        send.append(() if q == rank else tuple(
            at[c] for c in range(q * part if blocked else 0,
                                 (q + 1) * part if blocked else size)
            if c in at and c not in read))
        fill.append(tuple(c - lo for c in theirs
                          if lo <= c < lo + part and c not in at))
    keep = [(at[c], c - lo) for c in range(lo, lo + part) if c in at]
    if sum(map(len, fill)) + len(keep) != part:
        raise ValueError("the columns read do not cover the block")
    return (sum(send, ()), tuple(map(len, send)), sum(fill, ()),
            tuple(map(len, fill)), tuple(a for a, _ in keep),
            tuple(b for _, b in keep))


def relay_back(y: torch.Tensor, dim: int, size: int, need: tuple,
               rank: int, n: int, group, blocked: bool) -> torch.Tensor:
    """The inverse of :func:`relay` for a result computed redundantly
    where ranks' columns overlap (the conv state: ``B`` and ``C`` on every
    rank): ``y`` holds this rank's ``need[rank]`` columns along ``dim``;
    -> this rank's contiguous block of the ``size`` columns (``blocked``),
    else all of them, each column from the rank that read it, this rank
    first.  One all-to-all over ``group``; no gradient."""
    send, n_send, fill, n_fill, kept, keep_at = _relay_back_plan(
        size, need, rank, n, blocked)
    rows = y.movedim(dim, 0)
    dev = y.device
    got = _exchange(rows.index_select(0, _index(send, dev)), n_send, n_fill,
                    group)
    out = rows.new_empty((size // n if blocked else size,)
                         + tuple(rows.shape[1:]))
    out.index_copy_(0, _index(fill, dev), got)
    out.index_copy_(0, _index(keep_at, dev),
                    rows.index_select(0, _index(kept, dev)))
    return out.movedim(0, dim)


# ---------------------------------------------------------------- constraint
def shard(x, *axes: str | None):
    """Constrain activation ``x`` to its logical axes' sharding: the
    identity, returning ``x`` itself.  The reference's constraint tells
    GSPMD how to lay out a global array; here every rank's activations
    already are its own local slice (its rows of the batch, whole along
    ``"model"``), so there is nothing to move."""
    return x
