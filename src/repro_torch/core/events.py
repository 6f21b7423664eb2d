"""Discrete-event simulation core.

A copy of ``repro/core/events.py`` (``EventLoop``, ``NETWORK_DELAY``), so
the port's event backend imports nothing of the reference.

A minimal, deterministic event loop shared by every scheduler architecture
(Megha, Sparrow, Eagle, Pigeon).  Events are (time, seq, callback) tuples in a
binary heap; ``seq`` is a monotone tiebreaker so simultaneous events fire in
insertion order, which keeps runs bit-reproducible.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# Constant network delay between any two scheduler components, per the paper
# (§4.1: "the network delay for each communication was set to a constant value
# of 0.5ms in all the simulation experiments").
NETWORK_DELAY = 0.0005


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class EventLoop:
    """Deterministic discrete-event loop."""

    def __init__(self) -> None:
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self.events_processed: int = 0

    def push(self, delay: float, fn: Callable[[], None]) -> _Event:
        """Schedule ``fn`` to run ``delay`` seconds from now."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = _Event(self.now + delay, next(self._seq), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def push_at(self, time: float, fn: Callable[[], None]) -> _Event:
        if time < self.now:
            raise ValueError(f"event in the past: {time} < {self.now}")
        ev = _Event(time, next(self._seq), fn)
        heapq.heappush(self._heap, ev)
        return ev

    @staticmethod
    def cancel(ev: _Event) -> None:
        ev.cancelled = True

    def run(self, until: Optional[float] = None, max_events: Optional[int] = None) -> None:
        """Drain the heap (optionally bounded by time or event count)."""
        n = 0
        while self._heap:
            ev = self._heap[0]
            if until is not None and ev.time > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.time
            ev.fn()
            self.events_processed += 1
            n += 1
            if max_events is not None and n >= max_events:
                return

    def empty(self) -> bool:
        return not any(not e.cancelled for e in self._heap)
