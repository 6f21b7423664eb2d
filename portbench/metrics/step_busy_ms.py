"""step_busy_ms: device busy ms a round: the union of the device's intervals
in the profiled stretch, over its rounds."""


def read(ctx):
    if not ctx.get("busy_s"):
        return None
    return 1e3 * ctx["busy_s"] / ctx["stretch_rounds"]
