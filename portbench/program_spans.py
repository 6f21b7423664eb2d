"""What the readers of the program's own spans share.

The program (``repro_torch.simx.spans``) records its spans and counters
while a profiler runs, so the one record a traced run holds is the profiled
stretch's.  ``record`` takes it from the program once per run and keeps it
in the readers' context for the others; a program without the recorder, a
stretch that recorded nothing, and a run off the card give None.

``idle_split`` splits the device's idle time between the stretch's first
and last device op.  The gaps are those between the intervals of the busy
union (as ``devtrace.busy_seconds`` forms it).  A gap that starts inside a
span marked ``read`` (a host read: the card drains while the host waits,
then waits for the host's next launch) goes to the round loop; so does a
gap whose midpoint lies in no span inside ``simx.dispatch`` (the runtime's
stages, the Python loop, between rounds); the rest go to the rule step.
Each gap is named by the innermost span open at the point that decided it.

The spans are on the host's clock, and so are the profiler's host events;
its device events are converted from the card's clock, and were seen on
the card up to 0.48 ms early against the host calls that launched them.
``device_offset`` puts them back: paired in order with the host's launch
calls (one stream), no device operation starts before its launch.
"""

import bisect

#: the span of the rule's dispatch stage: the rule step's layer
DISPATCH = "simx.dispatch"
#: the name of a gap outside every span
NO_SPAN = "(no span)"
#: the host's runtime calls that each put one operation on the device
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"))


def record(ctx):
    """The profiled stretch's record of spans and counters, or None."""
    if "program_spans" not in ctx:
        try:
            from repro_torch.simx import spans
        except ImportError:
            ctx["program_spans"] = None
        else:
            ctx["program_spans"] = spans.take()
    rec = ctx["program_spans"]
    if not ctx.get("on_card") or rec is None or not rec.spans:
        return None
    return rec


def idle_gaps(device: list) -> list:
    """``(start s, end s)`` of the gaps between the busy union's intervals
    of ``device`` (``(name, start s, end s)`` events)."""
    gaps, edge = [], None
    for _, a, b in sorted(device, key=lambda e: e[1]):
        if edge is not None and a > edge:
            gaps.append((edge, a))
        edge = b if edge is None else max(edge, b)
    return gaps


def device_offset(ctx) -> float:
    """Seconds to add to the device events' times so that none starts before
    the host's launch call paired with it in order; 0 where none does, or
    where the launch calls and the device events do not pair one to one."""
    launches = sorted(a for name, a, _ in ctx.get("host", ()) if name in LAUNCHES)
    starts = sorted(a for _, a, _ in ctx["device"])
    if not starts or len(launches) != len(starts):
        return 0.0
    return max(0.0, max(h - d for h, d in zip(launches, starts)))


class Innermost:
    """The innermost closed span open at a time (seconds) of the profiler's
    clock; spans nest, so it is the last one to start by then or a span
    that encloses it."""

    def __init__(self, spans: list):
        self.spans = sorted((s for s in spans if s.end is not None), key=lambda s: s.start)
        self.starts = [s.start * 1e-9 for s in self.spans]

    def __call__(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and not (s.start * 1e-9 <= t < (s.end or 0) * 1e-9):
            s = s.parent
        return s


def idle_split(ctx):
    """``(step s, loop s, {innermost span name: s})`` of the stretch's idle
    time, or None where there is nothing to read."""
    rec, device = record(ctx), ctx.get("device")
    if rec is None or not device:
        return None
    at = Innermost(rec.spans)
    off = device_offset(ctx)
    step = loop = 0.0
    by: dict = {}
    for g0, g1 in idle_gaps(device):
        g0, g1 = g0 + off, g1 + off
        s = at(g0)
        if s is not None and s.reading():
            loop += g1 - g0
        else:
            s = at(0.5 * (g0 + g1))
            if s is not None and s.inside(DISPATCH):
                step += g1 - g0
            else:
                loop += g1 - g0
        name = s.name if s is not None else NO_SPAN
        by[name] = by.get(name, 0.0) + (g1 - g0)
    return step, loop, by
