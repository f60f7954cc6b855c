"""Deterministic discrete-event core for fleet-scale simulation.

``EventQueue`` is the event loop of the asynchronous PS trainer
(``repro_torch.ps.async_mode``): a binary heap whose entries are
``(time, seq, worker, payload)`` where ``seq`` is a global monotone
insertion counter.  The three-part key gives

* **total order** — ``seq`` is unique, so two entries never compare
  equal and the payload is never inspected;
* **stable tie-breaking** — events at the same simulated time pop in
  insertion order (then worker id, vacuously), independent of payload
  contents, heap layout, or Python version;
* **bit-reproducibility at scale** — the pop sequence of a
  thousand-worker simulation is a pure function of the push sequence.

The queue is plain data end to end: ``state()`` / ``from_state`` round-
trip it through JSON-able lists (payloads permitting).  No wall clock, no
RNG.  The module uses only the standard library and is the reference's
``repro/fleet/engine.py`` verbatim below this docstring, so the pop order
of every event loop equals the reference's.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence: ``worker``'s ``payload`` fires at
    simulated ``time``; ``seq`` is the queue-assigned insertion index."""

    time: float
    seq: int
    worker: int
    payload: Any = None

    def key(self) -> Tuple[float, int, int]:
        return (self.time, self.seq, self.worker)


class EventQueue:
    """Heap-ordered event queue with ``(time, seq, worker)`` keys.

    ``push`` assigns the next ``seq`` and returns the :class:`Event` (the
    caller can remember ``seq`` to recognise — or lazily invalidate — the
    event when it pops).  Iteration yields live events in arbitrary
    (heap) order: use it for scans like "minimum pinned version over
    everything in flight", never for anything order-sensitive.
    """

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, Any]] = []
        self._next_seq = 0

    # -- core ----------------------------------------------------------

    def push(self, time: float, worker: int, payload: Any = None) -> Event:
        if time < 0:
            raise ValueError(f"event time must be >= 0, got {time}")
        ev = Event(time=float(time), seq=self._next_seq, worker=int(worker),
                   payload=payload)
        self._next_seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev.worker, ev.payload))
        return ev

    def pop(self) -> Event:
        if not self._heap:
            raise IndexError("pop from an empty EventQueue")
        t, seq, worker, payload = heapq.heappop(self._heap)
        return Event(time=t, seq=seq, worker=worker, payload=payload)

    def peek(self) -> Event:
        if not self._heap:
            raise IndexError("peek at an empty EventQueue")
        t, seq, worker, payload = self._heap[0]
        return Event(time=t, seq=seq, worker=worker, payload=payload)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self) -> Iterator[Event]:
        for t, seq, worker, payload in self._heap:
            yield Event(time=t, seq=seq, worker=worker, payload=payload)

    # -- bulk edits ----------------------------------------------------

    def remove_if(self, pred: Callable[[Event], bool]) -> int:
        """Drop every event matching ``pred``; returns how many.

        Deterministic: keys are unique, so the surviving heap's pop order
        does not depend on the removal order."""
        kept = [e for e in self._heap
                if not pred(Event(time=e[0], seq=e[1], worker=e[2],
                                  payload=e[3]))]
        removed = len(self._heap) - len(kept)
        if removed:
            heapq.heapify(kept)
            self._heap = kept
        return removed

    def clear(self) -> None:
        self._heap = []

    # -- serialization -------------------------------------------------

    def state(self) -> dict:
        """Plain-data snapshot (payloads must already be plain data —
        encode array-bearing payloads before calling)."""
        return {
            "next_seq": self._next_seq,
            "entries": [[t, seq, worker, payload]
                        for t, seq, worker, payload in sorted(
                            self._heap, key=lambda e: e[:3])],
        }

    @classmethod
    def from_state(cls, state: dict, *,
                   decode: Optional[Callable[[Any], Any]] = None
                   ) -> "EventQueue":
        q = cls()
        q._next_seq = int(state["next_seq"])
        heap = []
        for t, seq, worker, payload in state["entries"]:
            if decode is not None:
                payload = decode(payload)
            heap.append((float(t), int(seq), int(worker), payload))
        heapq.heapify(heap)
        q._heap = heap
        return q
