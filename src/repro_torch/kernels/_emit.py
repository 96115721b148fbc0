"""What every emitted kernel's template needs from a schedule order: where
each shared-memory buffer lives, and where a wait or a ``__syncthreads()``
must stand.

Every value a MEM instruction produces gets its own shared buffer, so no
legal reorder can race on a buffer another value still needs.  Buffers are
placed by liveness in the given order (first fit over the instructions from
a buffer's first to its last touch), so an interleaved order reuses one
step's space while a hoisted order needs more.  :class:`SyncPlanner` then
puts a barrier before an instruction that reads a buffer written by other
threads since the last barrier, or writes over a region read or written
since then.  :class:`AsyncPlanner` does the same for kernels whose MEM loads
are asynchronous copies (``cp.async``, one committed group per load): it
also waits, before the first reader of a group, for that group and every
older one, so the order alone decides how many loads are in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.ir import Instr, Kind, Program

ALIGN = 16


@dataclasses.dataclass(frozen=True)
class SharedPlan:
    offsets: dict[str, int]        # buffer -> byte offset
    sizes: dict[str, int]          # buffer -> bytes
    total: int                     # bytes of dynamic shared memory

    def region(self, buf: str) -> tuple[int, int]:
        return self.offsets[buf], self.offsets[buf] + self.sizes[buf]


def _touches(ins: Instr, buffer_of: Mapping[str, str]) -> tuple[set, set]:
    reads = {buffer_of[v] for v in ins.inputs if v in buffer_of}
    writes = {buffer_of[v] for v in ins.outputs if v in buffer_of}
    return reads, writes


def plan_shared(program: Program, order: Sequence[int],
                buffer_of: Mapping[str, str], sizes: Mapping[str, int],
                pinned: Sequence[str] = ()) -> SharedPlan:
    """Place the buffers of ``sizes`` by liveness in ``order``.

    ``buffer_of`` maps IR value names to buffers (values that live in
    registers are absent); ``pinned`` buffers live through the whole body
    (they carry state across the kernel's loop)."""
    span: dict[str, list[int]] = {}
    for pos, idx in enumerate(order):
        reads, writes = _touches(program.instrs[idx], buffer_of)
        for b in reads | writes:
            lo_hi = span.setdefault(b, [pos, pos])
            lo_hi[1] = pos
    for b in pinned:
        span[b] = [-1, len(order)]
    placed: list[tuple[int, int, int, int]] = []      # (lo, hi, off, end)
    offsets: dict[str, int] = {}
    for b in sorted(span, key=lambda b: (span[b][0], b)):
        lo, hi = span[b]
        size = -(-sizes[b] // ALIGN) * ALIGN
        busy = sorted((o, e) for plo, phi, o, e in placed
                      if plo <= hi and lo <= phi)
        off = 0
        for o, e in busy:
            if off + size <= o:
                break
            off = max(off, e)
        offsets[b] = off
        placed.append((lo, hi, off, off + size))
    total = max((e for *_, e in placed), default=0)
    return SharedPlan(offsets=offsets,
                      sizes={b: sizes[b] for b in offsets}, total=total)


class SyncPlanner:
    """``Program.emit``'s ``before`` hook: returns ``__syncthreads();``
    where the next instruction would otherwise race with other threads'
    shared-memory accesses since the last barrier."""

    def __init__(self, plan: SharedPlan, buffer_of: Mapping[str, str]):
        self.plan = plan
        self.buffer_of = buffer_of
        self.read: list[tuple[int, int]] = []
        self.written: list[tuple[int, int]] = []

    @staticmethod
    def _overlap(a: tuple[int, int], regions: list[tuple[int, int]]) -> bool:
        return any(a[0] < e and o < a[1] for o, e in regions)

    def __call__(self, ins: Instr) -> str:
        reads, writes = _touches(ins, self.buffer_of)
        r = [self.plan.region(b) for b in reads]
        w = [self.plan.region(b) for b in writes]
        need = any(self._overlap(x, self.written) for x in r) or \
            any(self._overlap(x, self.written + self.read) for x in w)
        text = ""
        if need:
            text = "__syncthreads();"
            self.read, self.written = [], []
        self.read += r
        self.written += w
        return text


class AsyncPlanner(SyncPlanner):
    """``Program.emit``'s ``before`` hook for kernels whose MEM loads issue
    ``cp.async`` copies and then commit them as one group, unconditionally.

    Walking the order it numbers the groups and remembers which group
    filled each buffer.  Ahead of an instruction that reads a buffer whose
    group may still be in flight it emits ``cp_async_wait<N>();``, N being
    the number of groups committed after the newest one the instruction
    needs, then ``fence_proxy_async();`` when the instruction is in
    ``proxy_readers`` (its operands are read by ``wgmma``, through the async
    proxy), then ``__syncthreads();``.  Otherwise it places barriers as
    :class:`SyncPlanner` does: before overwriting a region read or written
    since the last barrier.  A ``wgmma`` reader waits for its own products
    before it ends, so that barrier also orders its reads.  The group count
    restarts with each planner: a loop body must read, within the same
    iteration, every group it commits (each template's loop begins with a
    barrier)."""

    def __init__(self, plan: SharedPlan, buffer_of: Mapping[str, str],
                 proxy_readers: frozenset[str] = frozenset()):
        super().__init__(plan, buffer_of)
        self.proxy_readers = proxy_readers
        self.committed = 0                 # groups committed so far
        self.complete = -1                 # groups <= this one have landed
        self.group_of: dict[str, int] = {}

    def __call__(self, ins: Instr) -> str:
        reads, writes = _touches(ins, self.buffer_of)
        pending = [self.group_of[b] for b in reads
                   if self.group_of.get(b, -1) > self.complete]
        lines = []
        if pending:
            newest = max(pending)
            n = self.committed - 1 - newest
            lines.append(f"cp_async_wait<{n}>();")
            self.complete = newest
            if ins.name in self.proxy_readers:
                lines.append("fence_proxy_async();")
            self.read, self.written = [], []
            lines.append("__syncthreads();")
        barrier = super().__call__(ins)
        if barrier:
            lines.append(barrier)
        if ins.kind is Kind.MEM and not ins.is_store and writes:
            for b in writes:
                self.group_of[b] = self.committed
            self.committed += 1
        return "\n".join(lines)


def divisor_at_most(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is at most ``cap``."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def cfloat(x: float) -> str:
    """A float32 literal for CUDA C++."""
    return f"{x!r}f" if "e" in repr(x) or "." in repr(x) else f"{x!r}.0f"


def emit_kernel(template: str, defines: Mapping[str, object],
                buffers: str, body: str) -> str:
    """Fill a ``csrc`` template: ``#define`` lines first, then the template
    with ``/*@BUFFERS@*/`` and ``/*@BODY@*/`` replaced."""
    head = "".join(f"#define {k} {v}\n" for k, v in defines.items())
    for mark in ("/*@BUFFERS@*/", "/*@BODY@*/"):
        if mark not in template:
            raise ValueError(f"template lacks {mark}")
    return head + template.replace("/*@BUFFERS@*/", buffers) \
        .replace("/*@BODY@*/", body)


def buffer_decls(plan: SharedPlan, ctype: Mapping[str, str]) -> str:
    """One pointer per buffer into the dynamic shared memory ``smem``."""
    return "\n".join(
        f"    {ctype[b]}* const {b} = reinterpret_cast<{ctype[b]}*>"
        f"(smem + {plan.offsets[b]});" for b in sorted(plan.offsets))


def random_legal_order(program: Program, seed: int,
                       moves: int = 64) -> tuple[int, ...]:
    """A legal order reached from the default by ``moves`` random legal ±1
    moves of MEM instructions (the annealer's own action), from ``seed``."""
    rng = np.random.default_rng(seed)
    order = program.default_order()
    for _ in range(moves):
        legal = program.legal_moves(order)
        if not legal:
            break
        idx, direction = legal[int(rng.integers(len(legal)))]
        order = program.move(order, idx, direction)
    return order
