"""match_share: the match kernels' share (%) of the device's busy time in
the profiled stretch."""

from portbench.metrics_common import match_events


def read(ctx):
    ev = match_events(ctx)
    if not ev or not ctx.get("busy_s"):
        return None
    return 100.0 * sum(b - a for _, a, b in ev) / ctx["busy_s"]
