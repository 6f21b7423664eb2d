"""idle_share: share (%) of the profiled stretch's wall in which the device
ran nothing."""


def read(ctx):
    if not ctx.get("busy_s"):
        return None
    return 100.0 * (ctx["window_s"] - ctx["busy_s"]) / ctx["window_s"]
