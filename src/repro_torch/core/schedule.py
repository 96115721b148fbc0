"""Schedule representation and search space.

A :class:`Schedule` is a point in the SIP search space: the instruction-order
permutation (the paper's space, §3.1) plus optional macro knobs (tile
shapes — tagged beyond-paper;
faithful mode keeps knobs frozen and searches order only).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

from repro_torch.core.ir import Program


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One discrete macro knob, e.g. block_m in {128, 256, 512}."""

    name: str
    choices: tuple[Any, ...]

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"knob {self.name} has no choices")


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Search space = instruction permutations x knob grid."""

    knobs: tuple[KnobSpec, ...] = ()

    def default_knobs(self) -> dict[str, Any]:
        return {k.name: k.choices[0] for k in self.knobs}

    def knob(self, name: str) -> KnobSpec:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(name)

    def contains(self, knobs: Mapping[str, Any]) -> bool:
        """True when every (name, value) is a legal point of this space —
        the warm-start compatibility check: a schedule imported from another
        signature's history may only seed a search here if its knobs all
        exist in THIS space and sit on declared choices."""
        by_name = {k.name: k.choices for k in self.knobs}
        return all(name in by_name and value in by_name[name]
                   for name, value in knobs.items())


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An immutable schedule candidate.

    ``order`` is None until the kernel factory instantiates its Program for
    the chosen knobs (the instruction count can depend on tile sizes — e.g.
    the number of K-steps in a GEMM body).
    """

    knobs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    order: tuple[int, ...] | None = None

    def with_order(self, order: Sequence[int]) -> "Schedule":
        return dataclasses.replace(self, order=tuple(int(i) for i in order))

    def with_knob(self, name: str, value: Any) -> "Schedule":
        knobs = dict(self.knobs)
        knobs[name] = value
        # knob changes invalidate the order (instruction count may change)
        return Schedule(knobs=knobs, order=None)

    def resolve_order(self, program: Program) -> tuple[int, ...]:
        if self.order is not None and len(self.order) == len(program):
            return self.order
        return program.default_order()

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({"knobs": dict(self.knobs),
                           "order": list(self.order) if self.order is not None else None},
                          sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Schedule":
        d = json.loads(s)
        order = tuple(d["order"]) if d.get("order") is not None else None
        return Schedule(knobs=d.get("knobs", {}), order=order)

    def signature(self) -> str:
        return self.to_json()

    def knob_signature(self) -> str:
        """Canonical key for the knob point alone — the Program IR depends
        only on knobs, so program/simulation memos key on this."""
        return json.dumps(dict(self.knobs), sort_keys=True, default=str)
