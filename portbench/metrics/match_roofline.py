"""match_roofline: the match kernels' share (%) of their roofline over the
profiled stretch: the sum of each launch's bound over the sum of its
profiled time.

The bound of one launch of the rank-and-select over ``avail [rows, width]``
with ``n [rows]`` is the larger of two times: the bytes the input needs
over the card's HBM rate, and its operations (one add a lane) over the
scalar peak.  The bytes count each output rank written once (int32 a lane),
each ``n`` read once, and of ``avail`` only the lanes the answer depends on:
a row's lanes up to its n-th free one (all when fewer are free, none when
n = 0).  Shapes and lane counts come from the benchmark's probe around the
match; nothing here depends on how the kernel is written.  Peaks: the H100
data sheet (``portbench/peaks.json``), at the 700 W power limit; the result
line's ``card`` gives the card's own limit."""

from portbench.metrics_common import match_events


def launch_bytes(rows: int, width: int, elem: int, lanes: int) -> int:
    """Bytes one launch needs: ``lanes`` input lanes of ``elem`` bytes, the
    int32 ranks of every lane and the int32 ``n`` of every row."""
    return lanes * elem + 4 * rows * width + 4 * rows


def bound_s(rows: int, width: int, elem: int, lanes: int, peaks: dict) -> float:
    """The least time one launch can take on the card."""
    return max(launch_bytes(rows, width, elem, lanes) / peaks["hbm_bytes_per_s"],
               rows * width / peaks["fp32_ops_per_s"])


def read(ctx):
    ev, launches = match_events(ctx), ctx.get("match_launches")
    if not ev or not launches or len(ev) != len(launches):
        return None
    bound = sum(bound_s(x["rows"], x["width"], x["elem"], x["lanes"], ctx["peaks"])
                for x in launches)
    return 100.0 * bound / sum(b - a for _, a, b in ev)
