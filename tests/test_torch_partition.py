"""The port's logical-axis rules and shape records against the JAX
package's, on the CPU.

``resolve_spec`` reads only the mesh's ``shape``, in both packages, so
both run here on a stand-in mesh of any size: every param leaf of every
architecture (the reference's axes at the reference's shapes, the port's at
its own), every decode-cache leaf and every batch leaf, on five meshes,
under the default rules, the serving rules and overrides.  ``cache_sds``
is held to the reference's shapes and to the structure the port's
``prefill`` returns; ``batch_sds`` to the reference's.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.dist import partition as jpart  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.dist import partition as tpart  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


@dataclasses.dataclass
class StandIn:
    """A mesh as ``resolve_spec`` sees it: axis sizes, and a rank's
    coordinates for ``NamedSharding.local``."""

    shape: dict
    coords: dict = dataclasses.field(default_factory=dict)

    def coord(self, axis):
        return self.coords[axis]

    @property
    def axis_names(self):
        return tuple(self.shape)


MESHES = [StandIn({"data": 4, "model": 2}), StandIn({"data": 2, "model": 4}),
          StandIn({"data": 1, "model": 8}), StandIn({"data": 8, "model": 1}),
          StandIn({"pod": 2, "data": 16, "model": 16})]
RULES = {"default": None, "serve": "SERVE_RULES",
         "seq_on_model": {"seq": "model"},
         "embed_on_data_model": {"embed": ("data", "model"),
                                 "seq": "model"}}


def _rules(name, pkg):
    r = RULES[name]
    if r is None:
        return pkg.DEFAULT_RULES
    if isinstance(r, str):
        return getattr(pkg, r)
    return {**pkg.DEFAULT_RULES, **r}


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """(axes, shapes) of every param leaf of the reference, by path."""
    cfg = jconfigs.get(arch)
    tree = JM.init_lm_shapes(jax.random.PRNGKey(0), cfg)
    axes = jax.tree_util.tree_flatten_with_path(
        jnn.axes_of(tree), is_leaf=jpart._is_axes_leaf)[0]
    shapes = jax.tree_util.tree_flatten_with_path(jnn.unwrap(tree))[0]

    def key(path):
        return "/".join(p.key for p in path)
    return ({key(p): a for p, a in axes},
            {key(p): tuple(s.shape) for p, s in shapes})


def _port_params(arch):
    cfg = tconfigs.get(arch)
    return (flatten(TM.param_logical_axes(cfg)),
            flatten(tsteps.param_sds(cfg)))


def _same(t, j):
    return tuple(t) == tuple(j)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", tconfigs.arch_names())
def test_param_specs_are_the_reference(arch, rules):
    """Every param leaf resolves as the reference resolves it, at its real
    shape, on every mesh (the port's axes and shapes are the reference's,
    leaf for leaf)."""
    j_axes, j_shapes = _reference_params(arch)
    t_axes, t_sds = _port_params(arch)
    assert sorted(j_axes) == sorted(t_axes)
    for path, axes in t_axes.items():
        assert tuple(axes) == tuple(j_axes[path]), path
        assert tuple(t_sds[path].shape) == j_shapes[path], path
    for mesh in MESHES:
        for path, axes in t_axes.items():
            shape = j_shapes[path]
            want = jpart.resolve_spec(axes, mesh, shape=shape,
                                      rules=_rules(rules, jpart))
            got = tpart.resolve_spec(axes, mesh, shape=shape,
                                     rules=_rules(rules, tpart))
            assert isinstance(got, tpart.PartitionSpec)
            assert _same(got, want), (mesh.shape, path, got, want)


def _cache_leaves(tree):
    """The reference's cache tree with an encoder-decoder's ``cross`` tuple
    as the port's ``{'k', 'v'}`` dict."""
    if isinstance(tree, dict):
        return {k: _cache_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 and \
            not jpart._is_axes_leaf(tree):
        return {"k": tree[0], "v": tree[1]}
    return tree


@pytest.mark.parametrize("arch", tconfigs.arch_names())
def test_cache_and_batch_specs_are_the_reference(arch):
    """Cache and batch leaves: the same shapes and the same specs as the
    reference's on every mesh and rule table."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    j_axes = _cache_leaves(JM.cache_logical_axes(jcfg))
    j_sds = _cache_leaves(jsteps.cache_sds(jcfg, 8, 4096))
    t_axes, t_sds = TM.cache_logical_axes(tcfg), tsteps.cache_sds(tcfg, 8,
                                                                 4096)
    fj_axes, fj_sds = flatten(j_axes), flatten(j_sds)
    ft_axes, ft_sds = flatten(t_axes), flatten(t_sds)
    assert sorted(fj_sds) == sorted(ft_sds) == sorted(ft_axes)
    for k, sds in ft_sds.items():
        assert tuple(sds.shape) == tuple(fj_sds[k].shape), k
        assert str(sds.dtype).split(".")[-1] == str(fj_sds[k].dtype), k
        assert tuple(ft_axes[k]) == tuple(fj_axes[k]), k
    shape = jconfigs.ShapeSpec("t", "train", 256, 16)
    jb = jsteps.batch_sds(jcfg, shape)
    tb = tsteps.batch_sds(tcfg, tconfigs.ShapeSpec("t", "train", 256, 16))
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape)
        assert tsteps.BATCH_AXES[k] == jsteps.BATCH_AXES[k]
    for mesh in MESHES:
        shardings = flatten(tsteps.cache_shardings(tcfg, mesh, 8, 4096))
        for rules in RULES:
            for k, sds in ft_sds.items():
                want = jpart.resolve_spec(fj_axes[k], mesh, shape=sds.shape,
                                          rules=_rules(rules, jpart))
                got = shardings[k].spec if rules == "default" else \
                    tpart.resolve_spec(ft_axes[k], mesh, shape=sds.shape,
                                       rules=_rules(rules, tpart))
                assert _same(got, want), (mesh.shape, rules, k)
            for k, sds in tb.items():
                want = jpart.resolve_spec(jsteps.BATCH_AXES[k], mesh,
                                          shape=sds.shape,
                                          rules=_rules(rules, jpart))
                got = tsteps.batch_shardings(tb, mesh)[k].spec \
                    if rules == "default" else tpart.resolve_spec(
                        tsteps.BATCH_AXES[k], mesh, shape=sds.shape,
                        rules=_rules(rules, tpart))
                assert _same(got, want), (mesh.shape, rules, k)


@pytest.mark.parametrize("arch", tconfigs.arch_names())
def test_cache_sds_matches_prefill_structure(arch):
    """``cache_sds`` predicts the port's ``prefill`` caches exactly: tree,
    shapes and dtypes (the contract of the reference's
    tests/test_steps_and_loop.py, for the port)."""
    cfg = tconfigs.get_smoke(arch)
    max_len = 48
    params = TM.init_lm(cfg, seed=0, device="cpu")
    batch = {k: (torch.zeros(v.shape, dtype=v.dtype) if v.dtype == torch.int32
                 else torch.randn(v.shape).to(v.dtype))
             for k, v in tsteps.batch_sds(
                 cfg, tconfigs.ShapeSpec("t", "prefill", 32, 2),
                 with_labels=False).items()}
    with torch.inference_mode():
        _, caches = TM.prefill(params, batch, cfg, max_len=max_len)
    got = {k: (tuple(v.shape), v.dtype) for k, v in flatten(caches).items()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in
            flatten(tsteps.cache_sds(cfg, 2, max_len)).items()}
    assert got == want


def test_pick_microbatches_is_the_reference():
    for arch in ("qwen3-1.7b", "dbrx-132b"):
        jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
        for shape in jconfigs.SHAPES.values():
            tshape = tconfigs.SHAPES[shape.name]
            for mesh in MESHES:
                assert tsteps.pick_microbatches(tcfg, tshape, mesh) == \
                    jsteps.pick_microbatches(jcfg, shape, mesh)


class TestPartitionRules:
    """The reference's TestPartitionRules, for the port."""

    MESH = StandIn({"data": 1, "model": 1})

    def test_resolve_spec_rules(self):
        assert tpart.resolve_spec(("vocab", "embed"), self.MESH) == \
            tpart.PartitionSpec("model", "data")
        assert tpart.resolve_spec(("batch", "seq", None), self.MESH) == \
            tpart.PartitionSpec("data", None, None)

    def test_divisibility_fallback(self):
        mesh = StandIn({"data": 4, "model": 2})
        assert tpart.resolve_spec(("heads",), self.MESH, shape=(7,)) == \
            tpart.PartitionSpec("model")
        assert tpart.resolve_spec(("heads",), mesh, shape=(7,)) == \
            tpart.PartitionSpec(None)
        # innermost first: ("pod", "data") on 6 over a (2, 4, 2) mesh
        pod = StandIn({"pod": 2, "data": 4, "model": 2})
        assert tpart.resolve_spec(("batch",), pod, shape=(6,)) == \
            tpart.PartitionSpec("pod")
        assert tpart.resolve_spec(("batch",), pod, shape=(16,)) == \
            tpart.PartitionSpec(("pod", "data"))

    def test_no_axis_reuse_in_one_spec(self):
        spec = tpart.resolve_spec(("vocab", "mlp"), self.MESH)
        used = [s for s in spec if s is not None]
        assert len(used) == len(set(used)) == 1

    def test_pod_dropped_on_single_pod_mesh(self):
        assert tpart.resolve_spec(("batch",), self.MESH) == \
            tpart.PartitionSpec("data")

    def test_shard_noop_without_mesh(self):
        x = torch.ones(4, 4)
        assert tpart.shard(x, "batch", None) is x
        with tpart.mesh_rules(self.MESH):
            assert tpart.shard(x, "batch", None) is x

    def test_mesh_rules_nest_and_restore(self):
        assert tpart.active_mesh_rules() == (None, None)
        with tpart.mesh_rules(self.MESH, {"seq": "model"}):
            mesh, rules = tpart.active_mesh_rules()
            assert mesh is self.MESH and rules["seq"] == "model"
            with tpart.mesh_rules(MESHES[0]):
                assert tpart.active_mesh_rules()[1]["seq"] is None
            assert tpart.active_mesh_rules()[0] is self.MESH
        assert tpart.active_mesh_rules() == (None, None)


@pytest.mark.parametrize("shape,axes,want", [
    ((8, 6, 4), (("data", "model"), None, None), (1, 6, 4)),
    ((8, 6, 4), (None, "model", "data"), (8, 3, 1)),
    ((8, 6), (("pod", "data"), None), (2, 6)),
])
def test_local_blocks_tile_the_whole(shape, axes, want):
    """Every rank's ``local`` block, laid where GSPMD lays it (row-major
    over the axes of a dimension), tiles the whole tensor exactly once."""
    sizes = {"pod": 2, "data": 2, "model": 2} if any(
        isinstance(a, tuple) and "pod" in a for a in axes) else \
        {"data": 4, "model": 2}
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32) \
        .reshape(shape)
    cover = torch.zeros(shape)
    names = list(sizes)
    for flat in range(int(np.prod(list(sizes.values())))):
        coords = dict(zip(names, np.unravel_index(flat, list(sizes.values()))))
        mesh = StandIn(sizes, {k: int(v) for k, v in coords.items()})
        sh = tpart.NamedSharding(mesh, tpart.PartitionSpec(*axes), shape)
        block = sh.local(full)
        assert tuple(block.shape) == sh.local_shape == want
        idx = []
        for dim, entry in enumerate(axes):
            ways, b = 1, 0
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ways *= sizes[a]
                b = b * sizes[a] + mesh.coord(a)
            n = shape[dim] // ways
            idx.append(slice(b * n, (b + 1) * n))
        assert torch.equal(full[tuple(idx)], block)
        cover[tuple(idx)] += 1
    # a replicated axis holds every block once per rank along it
    assert torch.all(cover == cover.flatten()[0])


def test_sharding_helpers_read_the_rules_scope():
    """``launch/steps.py``'s helpers lay tensors out by the innermost
    ``mesh_rules`` scope's rules, and ``rules`` given to them win."""
    cfg = tconfigs.get_smoke("qwen3-1.7b")
    mesh = StandIn({"data": 2, "model": 2})
    batch = {"tokens": torch.empty((8, 16), device="meta")}

    def specs(**kw):
        return (flatten(tsteps.param_shardings(cfg, mesh, **kw))["embed"].spec,
                tsteps.batch_shardings(batch, mesh, **kw)["tokens"].spec,
                tsteps.cache_shardings(cfg, mesh, 4, 32, **kw)["k"].spec[1])

    P = tpart.PartitionSpec
    default = (P("model", "data"), P("data", None), "data")
    assert specs() == default
    with tpart.mesh_rules(mesh, {"embed": None, "batch": None}):
        assert specs() == (P("model", None), P(None, None), None)
        assert specs(rules=tpart.DEFAULT_RULES) == default
    assert specs() == default
