"""What a traced stretch of rounds shows: device intervals from a
``torch.profiler`` run, host syncs from torch's sync-debug mode, and the
match launches' shapes.

``busy_seconds`` is the union of the device's intervals (a copy of the
busy-interval arithmetic of ``chip_smoke.py``'s profile phases);
``count_syncs`` copies the method of
``repro_torch.analysis.sentinels.count_syncs`` (one warning per synchronising
call, counted), so that the benchmark's counter does not move when the
program's does.
"""

from __future__ import annotations

import bisect
import contextlib
import warnings

import torch

#: the text of the warning torch's sync-debug mode gives per synchronising call
_SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def count_syncs():
    """Count the host syncs made inside the block; yields a one-entry list
    whose value is set when the block ends.  Without a card nothing can
    synchronise and the count is 0."""
    box = [0]
    if not torch.cuda.is_available():
        yield box
        return
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(before)
            box[0] = sum(1 for w in caught if _SYNC_WARNING in str(w.message))


def events(prof) -> tuple[list, list]:
    """``(device, host)``: the profiler's raw events as ``(name, start s,
    end s)``, sorted by start; the device list holds kernels, copies and
    sets."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        span = (e.name(), a, a + e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type() == DeviceType.CPU:
            host.append(span)
    dev.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return dev, host


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def busy_seconds(spans: list) -> float:
    """The union of the device's intervals, in seconds."""
    busy, end = 0.0, -float("inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def top_ops(spans: list, n: int = 10) -> list:
    """The ``n`` device operations that took most time: ``[name, s]``."""
    by = {}
    for name, a, b in spans:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: list, host: list, n: int = 10) -> list:
    """The device's idle gaps, summed by what the host was doing at each
    gap's midpoint: the outermost host operation open then, or ``python``
    where none was (the interpreter between operations)."""
    tops, end = [], -float("inf")
    for name, a, b in host:          # outermost host operations only
        if a >= end:
            tops.append((name, a, b))
            end = b
    starts = [a for _, a, _ in tops]
    by, edge = {}, None
    for _, a, b in dev:
        if edge is not None and a > edge:
            mid = 0.5 * (edge + a)
            i = bisect.bisect_right(starts, mid) - 1
            name = tops[i][0] if i >= 0 and tops[i][2] >= mid else "python"
            by[name] = by.get(name, 0.0) + (a - edge)
        edge = b if edge is None else max(edge, b)
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def needed_lanes(avail: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int64[rows]: the lanes of each row of ``avail [rows, width]`` that the
    ranks depend on, for ``n [rows]`` tasks: up to the n-th free lane, all
    of them when fewer are free, none when n = 0."""
    c = torch.cumsum(avail, dim=1, dtype=torch.int32)
    before = (c < n[:, None]).sum(1)
    need = torch.where(c[:, -1] >= n, before + 1, avail.shape[1])
    return torch.where(n > 0, need, 0)


class MatchProbe:
    """The match function the traced grid is built with: the program's
    match, and beside it what the trace needs of each launch.

    ``mode`` ``"off"`` passes through; ``"shapes"`` records each launch's
    ``(rows, width, element size)`` (no device work, for the profiled
    stretch); ``"lanes"`` also counts, on the device and without a host
    read, the lanes each launch needs to read: of a row with ``n`` tasks,
    the lanes up to its n-th free one (none for n = 0, all when fewer are
    free)."""

    def __init__(self, match_fn):
        self.match_fn = match_fn
        self.mode = "off"
        self.shapes: list = []
        self.lanes: list = []

    def __call__(self, avail: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        if self.mode != "off" and avail.numel() and avail.device.type == "cuda":
            rows, width = avail.shape
            self.shapes.append((rows, width, avail.element_size()))
            if self.mode == "lanes":
                self.lanes.append(needed_lanes(avail, n).sum())
        return self.match_fn(avail, n)

    def take(self) -> tuple[list, list]:
        """The recorded shapes and lane counts (read to the host), reset."""
        shapes, lanes = self.shapes, [int(x) for x in self.lanes]
        self.shapes, self.lanes = [], []
        return shapes, lanes
