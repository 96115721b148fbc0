"""Analytic cost model for kernel schedules.

The paper (§3.3) considers two feedback sources and rejects cost modeling on
GPUs because the only available simulator (gpgpu-sim) is unmaintained and of
unknown fidelity for current hardware.  The JAX package targets a TPU, a
statically-scheduled VLIW machine for which a two-pipeline latency model is
predictive, and provides BOTH feedback paths; the port keeps both:

* :func:`simulate` — a two-unit (memory pipe + compute pipe) in-order issue
  model over a :class:`~repro_torch.core.ir.Program` schedule.  Memory ops
  are *asynchronous*: they occupy the memory pipe for their issue+transfer
  time and their results become available at completion; a compute op that
  reads a not-yet-ready value stalls.  Moving a load earlier (the paper's
  latency hiding, §2.3) therefore reduces simulated cycles.
* wall-clock measurement on the card lives in :mod:`repro_torch.core.energy`.

:data:`V5E` (the JAX package's TPU v5e constants: 197 TFLOP/s bf16, 819 GB/s
HBM) stays the default, so a search under ``CostModelEnergy`` follows the
same trajectory in both packages.  :data:`H100` carries the H100 SXM
80GB's data-sheet rates at 700 W (989 TFLOP/s dense bf16, 3.35 TB/s HBM3;
NVLink 4 at 450 GB/s a direction a GPU inside a node of 8, 400 Gb/s NDR
InfiniBand, 50 GB/s a GPU, across nodes), which the port's dry run
(``launch/dryrun.py``) prices its counts at.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.ir import Kind, Program

# --- TPU v5e hardware constants (per chip) --------------------------------
PEAK_FLOPS_BF16 = 197e12        # FLOP/s
HBM_BW = 819e9                  # bytes/s
ICI_BW_PER_LINK = 50e9          # bytes/s per link
VMEM_BYTES = 16 * 2 ** 20       # ~16 MiB lower bound of usable VMEM
VMEM_BW = 8 * HBM_BW            # VMEM is on-chip; ~an order faster than HBM
MXU_DIM = 128                   # systolic array edge
SUBLANE, LANE = 8, 128          # VREG tile geometry


@dataclasses.dataclass(frozen=True)
class Machine:
    """Latency parameters (seconds) for the two-pipe schedule simulator,
    and the rates between chips: ``link_bw`` (bytes/s a direction a chip)
    inside a node of ``node_chips``, ``net_bw`` across nodes; with
    ``node_chips`` 0 every chip is on one network at ``link_bw``."""

    mem_issue: float = 30e-9            # fixed DMA issue overhead
    mem_bw: float = HBM_BW              # bytes/s for MEM instrs
    flops: float = PEAK_FLOPS_BF16      # FLOP/s for COMPUTE instrs
    compute_issue: float = 5e-9         # fixed per-op overhead (VLIW bundle)
    link_bw: float = ICI_BW_PER_LINK    # bytes/s between chips of a node
    net_bw: float = ICI_BW_PER_LINK     # bytes/s between nodes
    node_chips: int = 0                 # chips a node (0: one network)

    def mem_time(self, nbytes: int) -> float:
        return self.mem_issue + nbytes / self.mem_bw

    def compute_time(self, flops: int) -> float:
        return self.compute_issue + flops / self.flops


V5E = Machine()

#: NVIDIA H100 SXM 80GB (data sheet, dense, at 700 W): NVLink 4 inside a
#: node of 8, 400 Gb/s NDR InfiniBand (one NIC a GPU) across nodes.  The
#: issue latencies are placeholders, not calibrated on the card: a global
#: load's issue cost and a warp instruction's issue cost still have to be
#: fitted to measured times.
H100 = Machine(mem_issue=30e-9, mem_bw=3.35e12, flops=989e12,
               compute_issue=5e-9, link_bw=450e9, net_bw=50e9, node_chips=8)


def simulate(program: Program, order: Sequence[int] | None = None,
             machine: Machine = V5E) -> float:
    """Simulated execution time (seconds) of ``program`` under ``order``.

    STRICTLY IN-ORDER issue (the property the paper exploits, §2.3: since
    Kepler the hardware "obeys the compiler-generated instructions" — a
    stalled instruction blocks everything behind it; TPUs are statically
    scheduled VLIW, same property).  A MEM instruction occupies the front
    end only for its issue slot and completes asynchronously (LDGSTS / DMA
    semantics); a COMPUTE instruction stalls at issue until its inputs are
    ready, and that stall delays every later instruction.  Moving loads
    earlier in the schedule is therefore the only way to hide their latency.
    """
    if order is None:
        order = program.default_order()
    if not program.is_legal(order):
        raise ValueError("illegal schedule order")
    ready: dict[str, float] = {}          # value name -> time available
    cursor = 0.0                          # front-end: next issue time
    mem_free = 0.0                        # memory pipe next-free time
    comp_free = 0.0                       # compute pipe next-free time
    finish = 0.0
    for idx in order:
        ins = program.instrs[idx]
        deps_ready = max((ready.get(v, 0.0) for v in ins.inputs), default=0.0)
        if ins.kind is Kind.MEM:
            start = max(cursor, mem_free, deps_ready)
            mem_free = start + machine.mem_issue       # pipe frees after issue
            cursor = start + machine.mem_issue
            done = start + machine.mem_time(ins.bytes)  # data lands later
        else:
            start = max(cursor, comp_free, deps_ready)  # in-order stall
            dur = machine.compute_time(ins.flops)
            comp_free = start + dur
            cursor = start + machine.compute_issue
            done = start + dur
        for v in ins.outputs:
            ready[v] = done
        finish = max(finish, done)
    # grid cells execute back-to-back on a core; total scales with the
    # program's replication count (see ir.Program)
    return finish * program.replications


def roofline_time(flops: int, hbm_bytes: int, collective_bytes: int = 0,
                  chips: int = 1, links: int = 1,
                  machine: Machine = V5E) -> dict[str, float]:
    """The three roofline terms (seconds) used throughout EXPERIMENTS.md,
    at ``machine``'s rates (collectives at its ``link_bw``)."""
    return {
        "compute_s": flops / (chips * machine.flops),
        "memory_s": hbm_bytes / (chips * machine.mem_bw),
        "collective_s": collective_bytes / (chips * links * machine.link_bw),
    }


def group_bw(machine: Machine, ranks) -> float:
    """The rate (bytes/s a chip) of a collective over ``ranks``: the
    slowest link the group crosses, chips numbered row-major onto nodes of
    ``machine.node_chips``."""
    if not machine.node_chips:
        return machine.link_bw
    nodes = {r // machine.node_chips for r in ranks}
    return machine.link_bw if len(nodes) == 1 else machine.net_bw


def dominant_term(terms: dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
