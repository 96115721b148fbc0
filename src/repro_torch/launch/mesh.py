"""Meshes over the ranks of a job (the port of ``repro.launch.mesh``).

The reference builds a mesh from the devices one process sees.  Here every
rank is a process of its own (``repro_torch.dist.spawn``), so a mesh lays
the job's ranks, in order, onto a grid of named axes and gives each axis
the process group of the ranks that differ only along it.  Build one inside
every rank, in the same order on every rank: groups are created
collectively.  A mesh may take fewer ranks than the job has (an elastic
reshape onto a smaller rung); the ranks it leaves out learn so and take no
part in its work.  Functions, not module-level constants: importing this
module never touches a process group or a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

#: seconds a rank of a ``--mesh`` job (``launch/serve.py``,
#: ``launch/train.py``) waits in one collective before the job fails:
#: longer than any gap between two collectives (a prefill's first kernel
#: build, or the first rank's checkpoint write that the others wait for)
MESH_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh: ``shape`` (axis name -> size, in axis
    order), ``axis_names``, the ``rank`` in the job, its ``device``, the
    job's ``backend``, the process group of each axis (:meth:`group`) and
    of the whole mesh (``everyone``).  A rank of the job that the mesh
    leaves out has ``contains`` False and no groups or coordinates."""

    shape: dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: dict[str, Any]
    coords: dict[str, int]
    everyone: Any = None
    contains: bool = True

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` through this one."""
        return self.groups[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[axis]

    def broadcast_int(self, value: int, axis: str) -> int:
        """``value`` as the first rank along ``axis`` has it."""
        group = self.groups[axis]
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return int(t.item())

    def broadcast_object(self, obj: Any) -> Any:
        """``obj`` (picklable) as the mesh's first rank, job rank 0, has
        it; every rank of the mesh must call this."""
        box = [obj]
        if self.size > 1:
            dist.broadcast_object_list(box, src=0, group=self.everyone)
        return box[0]


def _device() -> torch.device:
    if torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_for(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``prod(shape)`` ranks, the job's first ones (as the
    reference takes the first devices of its list), laid out row-major (the
    last axis varies fastest).  Every rank of the job must call it, in the
    same order: process groups are created collectively.  A rank past the
    mesh gets a :class:`Mesh` with ``contains`` False; a mesh larger than
    the job raises.  This rank's device is its current CUDA device once
    CUDA is initialized (``dist.spawn`` does so on a CUDA rank), else the
    CPU."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("mesh_for needs a process group: build the mesh "
                           "inside a rank (repro_torch.dist.spawn.run)")
    need, world = math.prod(shape), dist.get_world_size()
    if need > world:
        raise ValueError(f"mesh {shape} needs {need} ranks, the job has "
                         f"{world}")
    rank = dist.get_rank()
    inside = rank < need
    grid = torch.arange(need).reshape(shape)
    coords = (dict(zip(axes, (int(c) for c in
                              torch.nonzero(grid == rank)[0])))
              if inside else {})
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == world:
            groups[axis] = dist.group.WORLD
            continue
        # every rank of the job creates every group of the axis, in order
        lines = grid.movedim(i, -1).reshape(-1, shape[i])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    everyone = (dist.group.WORLD if need == world
                else dist.new_group(list(range(need))))
    return Mesh(shape=dict(zip(axes, shape)), rank=rank, device=_device(),
                backend=dist.get_backend(), groups=groups, coords=coords,
                everyone=everyone if inside else None, contains=inside)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod shapes over this job's ranks: (16, 16) as
    ("data", "model"), or (2, 16, 16) as ("pod", "data", "model") with
    ``multi_pod``.  Raises unless the job has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_for(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """Every rank of the job on a ("data", "model") mesh: (world / model,
    model), by default (world, 1)."""
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"job's {world} ranks")
    return mesh_for((world // model, model), ("data", "model"))


def chips(mesh: Mesh) -> int:
    return mesh.size
