"""Kernel-schedule instruction IR — the mutable stand-in for a sass stream.

SIP (the paper) mutates the order of *global-memory I/O instructions* inside a
disassembled ``cubin``.  Here the mutable artifact is a small
dependency-annotated instruction list with two faces per instruction:

* ``fn`` runs the tile op on torch tensors; :meth:`Program.execute` calls
  the ``fn``s in schedule order over the kernel's grid on the CPU;
* ``src`` is the instruction's CUDA C++ text; :meth:`Program.emit` lays the
  snippets out in schedule order, and the kernel's template wraps them into
  one ``__global__`` function that ``nvcc`` compiles per schedule.

The IR deliberately mirrors the paper's world:

* every :class:`Instr` is tagged ``MEM`` (load/store — the movable set after
  the paper's §3.1 pruning) or ``COMPUTE`` (everything else, immovable);
* dependencies are the usual RAW/WAR/WAW edges plus conservative same-buffer
  ordering between stores and any other access of that buffer — the analogue
  of the sass control-code wait/read/write barriers that make a reorder legal;
* a schedule is a permutation of instruction ids; §3.2's mutation policy only
  ever moves one MEM instruction up or down by one slot.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence


class Kind(enum.Enum):
    MEM = "mem"          # global-memory I/O — the movable set (paper §3.1)
    COMPUTE = "compute"  # arithmetic / MXU / VPU — fixed relative order


@dataclasses.dataclass(frozen=True)
class Instr:
    """One schedulable instruction.

    ``fn(env)`` performs the op when the program is *executed* on torch
    tensors: it reads ``env[v]`` for each input value name ``v`` and must
    return a dict of output values.  ``src`` is the same op as CUDA C++ text
    for :meth:`Program.emit`.

    ``bytes`` / ``flops`` feed the analytic cost model; for MEM ops ``bytes``
    is the transfer size, for COMPUTE ops ``flops`` is the op's work.
    """

    name: str
    kind: Kind
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    fn: Callable[[dict[str, Any]], dict[str, Any]]
    buffer: str | None = None       # buffer identity for memory-order edges
    is_store: bool = False
    bytes: int = 0
    flops: int = 0
    src: str = ""

    def __repr__(self) -> str:  # compact, sass-listing-like
        tag = "ST" if self.is_store else ("LD" if self.kind is Kind.MEM else "OP")
        return f"{tag} {self.name}({', '.join(self.inputs)}) -> {', '.join(self.outputs)}"


class Program:
    """An ordered instruction list with dependency analysis and legal ±1 moves.

    ``replications`` is the number of times the body executes per kernel
    launch (the grid size); the cost model multiplies by it so schedule
    knobs that shrink the body but multiply the grid are priced correctly.
    """

    def __init__(self, instrs: Sequence[Instr], replications: int = 1):
        self.instrs: list[Instr] = list(instrs)
        self.replications = max(int(replications), 1)
        names = [i.name for i in self.instrs]
        if len(set(names)) != len(names):
            raise ValueError("instruction names must be unique")
        self._deps = self._build_deps()

    # ------------------------------------------------------------------ deps
    def _build_deps(self) -> list[set[int]]:
        """deps[j] = set of instruction indices that must precede instr j."""
        deps: list[set[int]] = [set() for _ in self.instrs]
        last_writer: dict[str, int] = {}
        readers: dict[str, list[int]] = {}
        # memory-order state per buffer
        buf_last_store: dict[str, int] = {}
        buf_accesses: dict[str, list[int]] = {}
        for j, ins in enumerate(self.instrs):
            for v in ins.inputs:          # RAW
                if v in last_writer:
                    deps[j].add(last_writer[v])
            for v in ins.outputs:         # WAW / WAR
                if v in last_writer:
                    deps[j].add(last_writer[v])
                for r in readers.get(v, ()):
                    deps[j].add(r)
            if ins.buffer is not None:
                if ins.is_store:
                    # a store orders against every prior access of the buffer
                    for a in buf_accesses.get(ins.buffer, ()):
                        deps[j].add(a)
                elif ins.buffer in buf_last_store:
                    # a load orders against the last store to the buffer
                    deps[j].add(buf_last_store[ins.buffer])
            # update state
            for v in ins.inputs:
                readers.setdefault(v, []).append(j)
            for v in ins.outputs:
                last_writer[v] = j
                readers[v] = []
            if ins.buffer is not None:
                buf_accesses.setdefault(ins.buffer, []).append(j)
                if ins.is_store:
                    buf_last_store[ins.buffer] = j
        for j in range(len(deps)):
            deps[j].discard(j)
        return deps

    @property
    def deps(self) -> list[set[int]]:
        return self._deps

    def default_order(self) -> tuple[int, ...]:
        """The compiler-like baseline schedule: program order (= ptxas O3 stand-in)."""
        return tuple(range(len(self.instrs)))

    def mem_indices(self) -> list[int]:
        """Indices of the movable (global-memory I/O) instructions — §3.1 pruning."""
        return [i for i, ins in enumerate(self.instrs) if ins.kind is Kind.MEM]

    # ----------------------------------------------------------------- legal
    def is_legal(self, order: Sequence[int]) -> bool:
        if sorted(order) != list(range(len(self.instrs))):
            return False
        pos = {idx: p for p, idx in enumerate(order)}
        return all(pos[d] < pos[j] for j in range(len(self.instrs)) for d in self._deps[j])

    def swap_is_legal(self, order: Sequence[int], slot: int) -> bool:
        """Is swapping ``order[slot]`` and ``order[slot+1]`` dependency-legal?"""
        a, b = order[slot], order[slot + 1]
        return a not in self._deps[b] and b not in self._deps[a]

    def move(self, order: Sequence[int], instr_idx: int, direction: int) -> tuple[int, ...] | None:
        """Move instruction ``instr_idx`` up (-1) or down (+1) by one slot.

        Returns the new order, or None if the move is illegal / out of range.
        This is exactly the paper's §3.2 action: (which instruction, direction).
        """
        order = list(order)
        slot = order.index(instr_idx)
        tgt = slot + direction
        if tgt < 0 or tgt >= len(order):
            return None
        lo = min(slot, tgt)
        if not self.swap_is_legal(order, lo):
            return None
        order[slot], order[tgt] = order[tgt], order[slot]
        return tuple(order)

    def legal_moves(self, order: Sequence[int]) -> list[tuple[int, int]]:
        """All legal (mem_instr_idx, direction) actions from ``order``."""
        moves = []
        pos = {idx: p for p, idx in enumerate(order)}
        for idx in self.mem_indices():
            for direction in (-1, +1):
                slot = pos[idx]
                tgt = slot + direction
                if 0 <= tgt < len(order) and self.swap_is_legal(order, min(slot, tgt)):
                    moves.append((idx, direction))
        return moves

    # ------------------------------------------------------------------ emit
    def execute(self, env: dict[str, Any], order: Sequence[int] | None = None) -> dict[str, Any]:
        """Run the program's torch ``fn``s in schedule order (one grid step)."""
        if order is None:
            order = self.default_order()
        if not self.is_legal(order):
            raise ValueError("illegal schedule order")
        env = dict(env)
        for idx in order:
            ins = self.instrs[idx]
            out = ins.fn(env)
            if out:
                env.update(out)
        return env

    def emit(self, order: Sequence[int] | None = None,
             before: Callable[[Instr], str] | None = None) -> str:
        """The CUDA text of the program body: each instruction's ``src`` in
        schedule order.  ``before(instr)`` (optional) returns text to place
        ahead of that instruction, e.g. the ``__syncthreads()`` the kernel's
        template needs where an instruction reads what other threads wrote.
        """
        if order is None:
            order = self.default_order()
        if not self.is_legal(order):
            raise ValueError("illegal schedule order")
        lines = []
        for idx in order:
            ins = self.instrs[idx]
            if before is not None:
                lines.append(before(ins))
            lines.append(f"// {ins.name}" + (f"\n{ins.src}" if ins.src else ""))
        return "\n".join(line for line in lines if line)

    # ----------------------------------------------------------------- repr
    def listing(self, order: Sequence[int] | None = None) -> str:
        """sass-listing-style dump (cf. paper Listings 4/5)."""
        if order is None:
            order = self.default_order()
        return "\n".join(f"{p:4d}  {self.instrs[idx]!r}" for p, idx in enumerate(order))

    def __len__(self) -> int:
        return len(self.instrs)
