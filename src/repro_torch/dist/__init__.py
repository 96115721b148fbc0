"""Distributed serving: tensor parallelism at explicit seams (the port of the
serving half of ``repro.dist``).

* :mod:`repro_torch.dist.collectives` — per-block symmetric int8
  quantization and an int8-compressed all-reduce.
* :mod:`repro_torch.dist.tp` — manual tensor parallelism for serving: the
  rules that say which param dims shard, the per-layer all-reduce seams,
  and the eligibility gate.
* :mod:`repro_torch.dist.spawn` — an N-rank job of processes on one host,
  one process group among them, failing instead of hanging.

Meshes over a job's ranks are built by :mod:`repro_torch.launch.mesh`.  The
reference's compiler-placed sharding (``dist/partition.py`` under GSPMD)
and its pipeline (``dist/pipeline.py``) are not ported (ROADMAP.md, Queue 1
item 2).
"""

from repro_torch.dist import collectives, spawn, tp

__all__ = ["collectives", "spawn", "tp"]
