"""Dynamic sentinels: host syncs counted at run time (the torch counterpart
of ``repro/analysis/sentinels.py``).

The reference's sentinels count XLA compilations (``count_compiles``,
``assert_compiles_once``: one compiled segment per rule and config) and
catch tracers leaking out of a trace (``assert_no_tracer_leaks``).  Eager
torch compiles nothing and traces nothing, so neither has a torch meaning
and none of the three is ported.

What a torch round does have is host syncs: every device->host read
(megha's borrow check, a ``.cpu()``, a Python ``if`` on a tensor) makes the
host wait for the card, and blocks a CUDA graph of the round, the lever
``PERF.md`` names for the host-bound rounds.  ``simxlint`` finds those
reads in the source; ``count_syncs`` counts the ones a run really makes,
under ``torch.cuda.set_sync_debug_mode("warn")`` (one warning per
synchronising call).  Without a card nothing synchronises and the count
is 0.

``STEP_SYNCS_PER_ROUND`` pins the host syncs one round of each rule's
fixed-trace step makes on the card (the step built beforehand, no
telemetry, provenance or faults): megha's borrow check is the one read.
``SEGMENT_EXTRA_SYNCS`` pins what a stream segment adds to its rounds'.
``tests/test_torch_gpu.py`` holds every rule to both, and ``chip_smoke.py``
(phase ``analysis``) checks the paper-scale runs against them.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: host syncs of one round of each rule's step on the card, measured on an
#: NVIDIA H100 (``chip_smoke.py``, phase ``analysis``)
STEP_SYNCS_PER_ROUND = {"megha": 1, "sparrow": 0, "eagle": 0, "pigeon": 0, "oracle": 0}

#: host syncs of one stream segment (``stream._SteadyLoop.segment``, one
#: lane, after a refill) beyond its rounds', measured likewise: the
#: window's 7 task arrays uploaded from pageable host memory (a blocking
#: copy each, ``_StreamWindow.tasks``), the step factory's uploads of
#: numpy tables (megha's ``partition_gms``; pigeon's two group tables) and
#: the one read of the scalars
SEGMENT_EXTRA_SYNCS = {"megha": 9, "sparrow": 8, "eagle": 8, "pigeon": 10, "oracle": 8}

#: the text of the warning torch's sync-debug mode gives per synchronising
#: call (its one-time notice that the mode is a prototype is not one)
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclass
class SyncCount:
    """Mutable counter a ``count_syncs()`` block fills in: the syncs, and
    how many came from each ``file:line`` (the Python line that made the
    synchronising call)."""

    count: int = 0
    sites: collections.Counter = field(default_factory=collections.Counter)


@contextlib.contextmanager
def count_syncs():
    """Count the host syncs of the block: torch's sync-debug mode warns
    once per synchronising call, and the warnings are counted, not shown.
    Yields a ``SyncCount`` whose ``.count`` is set when the block ends; the
    earlier mode is restored even when the block raises."""
    counter = SyncCount()
    if not torch.cuda.is_available():
        # no card: nothing can synchronise with one, and torch's mode
        # cannot be read or set
        yield counter
        return
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counter
        finally:
            torch.cuda.set_sync_debug_mode(before)
            syncs = [w for w in caught if _SYNC_WARNING in str(w.message)]
            counter.count = len(syncs)
            counter.sites.update(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)


def sync_count(fn):
    """``fn()`` under ``count_syncs``: ``(result, host syncs)``."""
    with count_syncs() as c:
        out = fn()
    return out, c.count


def assert_syncs_at_most(fn, n: int, label: str = ""):
    """Run ``fn`` and fail when it made more than ``n`` host syncs; returns
    ``(result, syncs)``."""
    out, syncs = sync_count(fn)
    if syncs > n:
        raise AssertionError(
            f"{label or getattr(fn, '__name__', 'fn')}: {syncs} host syncs, "
            f"at most {n} allowed: a new host read in a step?")
    return out, syncs
