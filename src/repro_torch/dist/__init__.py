"""Distribution (the port of ``repro.dist``): tensor-parallel serving at
explicit seams, and the logical-axis rules and pipeline of sharded
training.

* :mod:`repro_torch.dist.collectives` — per-block symmetric int8
  quantization and an int8-compressed all-reduce.
* :mod:`repro_torch.dist.tp` — manual tensor parallelism for serving: the
  rules that say which param dims shard, the per-layer all-reduce seams,
  and the eligibility gate.
* :mod:`repro_torch.dist.spawn` — an N-rank job of processes on one host,
  one process group among them, failing instead of hanging.
* :mod:`repro_torch.dist.partition` — logical axes resolved to mesh axes
  under rule tables, and each rank's block of a tensor as GSPMD lays it
  out (what the sharded train step and checkpoints use), and the serving
  layout of the engine's GSPMD path with the model's layer-by-layer
  gathers.
* :mod:`repro_torch.dist.pipeline` — GPipe over one mesh axis, with a
  differentiable rotation.

Meshes over a job's ranks are built by :mod:`repro_torch.launch.mesh`.
"""

from repro_torch.dist import collectives, partition, pipeline, spawn, tp

__all__ = ["collectives", "partition", "pipeline", "spawn", "tp"]
