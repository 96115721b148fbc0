"""The one-device train step, captured: the port of the reference's jitted
train step with its params and optimizer state donated
(``repro/train/loop.py``'s ``jax.jit(train_step, donate_argnums=(0, 1))``).

A :class:`TrainGraph` captures ``steps.train_step`` whole, as a
:class:`~repro_torch.serve.graphs.CapturedStep` (its module docstring says
how a capture warms up, captures, replays, raises and runs on the CPU): the
forward under the config's remat policy (``models/blocks.remat``:
non-reentrant ``torch.utils.checkpoint`` without RNG state, whose recompute
runs inside the backward), ``torch.autograd.grad`` (its backward runs on
autograd's device thread, onto the capturing stream, so its allocations
land in the graph's pool), the microbatch loop, the global-norm clip and
AdamW in place (``optim/adamw.py``: its step, learning rate and bias
corrections are device scalars, so nothing reads back to the host).  The
params and moments are static already, since the step updates them in
place; each call copies the batch into static buffers, and the step's
metrics land in static 0-dim tensors that the caller reads after the
replay.  The graph has a memory pool of its own; ``torch.cuda.graph``
releases the warm-up's cached blocks before it captures.
"""

from __future__ import annotations

import torch

from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve.graphs import CapturedStep

#: the metrics of ``steps.train_step``
METRICS = ("loss", "aux/load_balance", "aux/router_z", "lr", "grad_norm")


class TrainGraph(CapturedStep):
    """``steps.train_step`` over ``params`` and ``opt_state`` (updated in
    place) and a static batch, captured on a CUDA device.  The first
    :meth:`step` fixes the batch's keys, shapes and dtypes; a batch that
    differs raises."""

    def __init__(self, params, opt_state, *, cfg: ModelConfig,
                 opt_cfg: adamw.OptConfig, num_microbatches: int = 1,
                 device: torch.device):
        super().__init__(device)
        self.params, self.opt_state = params, opt_state
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.num_microbatches = num_microbatches
        self.batch: dict[str, torch.Tensor] | None = None
        self.metrics = {k: torch.zeros((), dtype=torch.float32,
                                       device=device) for k in METRICS}

    def step(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` -> the static metrics, valid
        until the next call."""
        if self.batch is None:
            self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        got = {k: (v.shape, v.dtype) for k, v in batch.items()}
        want = {k: (v.shape, v.dtype) for k, v in self.batch.items()}
        if got != want:
            raise ValueError(f"train graph: batch {got}, captured for {want}")
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.run()
        return self.metrics

    def _step(self) -> None:
        _, _, metrics = steps.train_step(
            self.params, self.opt_state, self.batch, cfg=self.cfg,
            opt_cfg=self.opt_cfg, num_microbatches=self.num_microbatches)
        if set(metrics) != set(METRICS):
            raise ValueError(f"train graph: metrics {sorted(metrics)}")
        for k, v in metrics.items():
            self.metrics[k].copy_(v)
