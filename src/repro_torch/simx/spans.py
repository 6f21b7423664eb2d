"""Spans and counters of the round path, on the profiler's clock.

The round loop, ``compose_step``'s stages and the rules' dispatch sections
open named spans (``with span("megha.internal_match"):``) and bump named
counters (``count("megha.borrow_rounds", 1)``).  Recording is on only while
a ``torch.profiler`` runs or inside ``with session() as rec:``; otherwise
``span`` returns one shared no-op object (no allocation, no clock read) and
``count`` returns at once.

A span keeps its name, its start and end as ``time.time_ns()`` (Unix
nanoseconds, the clock of the profiler's ``kineto_results.events()``), the
span that encloses it, and the host loop's round index (``scan_rounds``'
loop counter, shared by every span of one round; None outside a round).
``read=True`` marks a span around a deliberate host read of a device value
(Megha's borrow check), where the host waits for the card.

Recording adds no device work: no ``record_function`` (the profiler would
list its range as a device event too), no NVTX range, no kernel, copy or
sync.  A counter of a device value keeps the tensor and sums it when the
record is closed (``take()``, or the end of a session), after the rounds.

What a profiler run records is kept until ``take()`` returns it and starts
afresh; a session's record is its own.  A record keeps at most
``MAX_SPANS`` spans and counter values; later ones are dropped and counted
in ``dropped``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

#: spans (and counter values) a record keeps; later ones are dropped
MAX_SPANS = 1_000_000

_clock = time.time_ns
#: the profiler's own flag, read once per site
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span; its own context manager."""

    __slots__ = ("name", "start", "end", "parent", "round", "read")

    def __init__(self, name: str, parent: Optional["Span"], round_index, read: bool):
        self.name, self.parent, self.round, self.read = name, parent, round_index, read
        self.start = self.end = None

    def __enter__(self):
        _stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        _stack.pop()
        return False

    def inside(self, name: str) -> bool:
        """Whether this span or one that encloses it is named ``name``."""
        s = self
        while s is not None:
            if s.name == name:
                return True
            s = s.parent
        return False

    def reading(self) -> bool:
        """Whether this span or one that encloses it is a host read."""
        s = self
        while s is not None:
            if s.read:
                return True
            s = s.parent
        return False


class _Off:
    """The span a site gets while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Record:
    """Spans in the order they opened, and counters by name.

    While it records, ``counters`` holds each counter's values as given;
    ``close()`` sums them (device values read to the host then) and
    ``counter_items`` gives how many values each sum took (a tensor counts
    its elements)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.counter_items: dict[str, int] = {}
        self.dropped = 0
        self._values = 0
        self.closed = False

    def close(self) -> "Record":
        """Sum the counters; returns the record."""
        if not self.closed:
            for name, values in self.counters.items():
                total, items = 0, 0
                for v in values:
                    if isinstance(v, torch.Tensor):
                        total += v.sum().item()
                        items += v.numel()
                    else:
                        total += v
                        items += 1
                self.counters[name], self.counter_items[name] = total, items
            self.closed = True
        return self

    def table(self) -> dict[str, dict]:
        """``name -> {"count", "total_ms", "self_ms"}`` over the closed
        spans; self time is a span's duration less its child spans'."""
        out: dict[str, dict] = {}
        child: dict[int, int] = {}
        done = [s for s in self.spans if s.end is not None]
        for s in done:
            if s.parent is not None:
                child[id(s.parent)] = child.get(id(s.parent), 0) + s.end - s.start
        for s in done:
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            dur = s.end - s.start
            row["count"] += 1
            row["total_ms"] += dur * 1e-6
            row["self_ms"] += (dur - child.get(id(s), 0)) * 1e-6
        return out


#: the spans open now, innermost last (recorded ones only)
_stack: list[Span] = []
#: open sessions, innermost last; spans go to the innermost
_sessions: list[Record] = []
#: what the profiler's runs recorded outside any session, until ``take()``
_profiled = Record()


def span(name: str, read: bool = False, round_index: Optional[int] = None):
    """A span named ``name`` for a ``with`` block; ``read=True`` marks a
    host read, ``round_index`` the round a ``simx.round`` span opens (the
    spans inside it take it from their parent)."""
    if _sessions:
        rec = _sessions[-1]
    elif _profiler_enabled():
        rec = _profiled
    else:
        return _OFF
    parent = _stack[-1] if _stack else None
    if round_index is None and parent is not None:
        round_index = parent.round
    s = Span(name, parent, round_index, read)
    if len(rec.spans) < MAX_SPANS:
        rec.spans.append(s)
    else:
        rec.dropped += 1
    return s


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed when the record closes)
    to the counter ``name``."""
    if _sessions:
        rec = _sessions[-1]
    elif _profiler_enabled():
        rec = _profiled
    else:
        return
    if rec._values < MAX_SPANS:
        rec._values += 1
        rec.counters.setdefault(name, []).append(value)
    else:
        rec.dropped += 1


def take() -> Record:
    """What the profiler's runs recorded since the last ``take()``, closed;
    recording starts afresh."""
    global _profiled
    rec, _profiled = _profiled, Record()
    return rec.close()


@contextlib.contextmanager
def session() -> Iterator[Record]:
    """Record every span and counter of the block (profiler or not) into
    the record it yields, closed when the block ends."""
    rec = Record()
    _sessions.append(rec)
    try:
        yield rec
    finally:
        _sessions.remove(rec)
        rec.close()
