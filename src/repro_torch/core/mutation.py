"""Mutation policy (paper §3.2).

"If there exist k memory I/O instructions, the mutation policy may choose one
of them to move up or down by one.  The exact instruction to move and
direction is randomly chosen.  The action vector is two discrete numbers."

Faithful mode samples exactly that action.  An illegal action (dependency
violation or boundary) is resampled — equivalent to the paper's rejection of
schedules that cannot be assembled.  ``knob_prob > 0`` additionally mutates a
macro knob with that probability (beyond-paper extension, off by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.ir import Program
from repro_torch.core.schedule import Schedule, SearchSpace


@dataclasses.dataclass
class MutationPolicy:
    space: SearchSpace
    program_for: Callable[[Schedule], Program]   # kernel factory's IR builder
    knob_prob: float = 0.0                       # 0.0 == paper-faithful
    max_resample: int = 64

    def propose(self, schedule: Schedule, rng: np.random.Generator) -> Schedule | None:
        """One SIP action. Returns None if no legal action exists."""
        if self.space.knobs and rng.random() < self.knob_prob:
            mutated = self._mutate_knob(schedule, rng)
            if mutated is not None:
                return mutated
        return self._mutate_order(schedule, rng)

    # ---------------------------------------------------------------- order
    def _mutate_order(self, schedule: Schedule, rng: np.random.Generator) -> Schedule | None:
        program = self.program_for(schedule)
        order = schedule.resolve_order(program)
        mem = program.mem_indices()
        if not mem:
            return None
        for _ in range(self.max_resample):
            instr_idx = mem[int(rng.integers(len(mem)))]   # which instruction
            direction = -1 if rng.random() < 0.5 else +1   # which direction
            new_order = program.move(order, instr_idx, direction)
            if new_order is not None and new_order != tuple(order):
                return schedule.with_order(new_order)
        return None

    # ---------------------------------------------------------------- knobs
    def _mutate_knob(self, schedule: Schedule, rng: np.random.Generator) -> Schedule | None:
        knobs = [k for k in self.space.knobs if len(k.choices) > 1]
        if not knobs:
            return None
        k = knobs[int(rng.integers(len(knobs)))]
        cur = schedule.knobs.get(k.name, k.choices[0])
        alt = [c for c in k.choices if c != cur]
        return schedule.with_knob(k.name, alt[int(rng.integers(len(alt)))])
