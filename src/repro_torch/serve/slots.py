"""Fixed-capacity slot allocator with FIFO admission — the bookkeeping core
of the continuous-batching engine, kept model-free so its invariants are
property-testable in isolation (tests/test_slot_allocator.py):

* no aliasing — a slot is held by at most one item at a time;
* FIFO admission — items are admitted strictly in submit order, even (and
  especially) under full occupancy;
* liveness — as long as slots keep being released, every submitted item is
  eventually admitted.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator


class SlotPool:
    """``capacity`` slots + a FIFO queue of waiting items.

    ``submit`` enqueues; ``admit`` pops waiting items into the lowest free
    slots (deterministic placement) and returns the ``(slot, item)`` pairs
    admitted now; ``release`` frees a slot for the next admission.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._free = list(range(capacity - 1, -1, -1))   # pop() -> lowest
        self._held: dict[int, Any] = {}                  # slot -> item
        self._queue: collections.deque[Any] = collections.deque()

    # ------------------------------------------------------------- queueing
    def submit(self, item: Any) -> None:
        self._queue.append(item)

    def admit(self) -> list[tuple[int, Any]]:
        admitted = []
        while self._queue and self._free:
            slot = self._free.pop()
            item = self._queue.popleft()
            self._held[slot] = item
            admitted.append((slot, item))
        return admitted

    def peek(self) -> Any | None:
        """The item at the head of the queue (the next FIFO admission), or
        None — lets resource-gated admission (the paged engine's page check)
        inspect head-of-line cost before committing a slot."""
        return self._queue[0] if self._queue else None

    def admit_one(self) -> tuple[int, Any] | None:
        """Admit exactly the head-of-line item into the lowest free slot, or
        None when the queue is empty / no slot is free.  With :meth:`peek`
        this is the FIFO-preserving building block for admission loops that
        must stop when some *other* resource (cache pages) runs out."""
        if not self._queue or not self._free:
            return None
        slot = self._free.pop()
        item = self._queue.popleft()
        self._held[slot] = item
        return slot, item

    def release(self, slot: int) -> Any:
        if slot not in self._held:
            raise KeyError(f"slot {slot} is not held")
        item = self._held.pop(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)                    # keep lowest-first
        return item

    # -------------------------------------------------------------- queries
    def item(self, slot: int) -> Any:
        return self._held[slot]

    def held(self) -> Iterator[tuple[int, Any]]:
        return iter(sorted(self._held.items()))

    @property
    def occupancy(self) -> int:
        return len(self._held)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._held and not self._queue

    def __contains__(self, slot: int) -> bool:
        return slot in self._held

    def __repr__(self) -> str:
        return (f"SlotPool(capacity={self.capacity}, "
                f"occupancy={self.occupancy}, queued={self.queue_depth})")
