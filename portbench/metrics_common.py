"""Helpers the metric readers share."""

#: the program's match kernels, by the name the profiler gives them
MATCH_KERNEL = "match_batched"


def match_events(ctx) -> list:
    """The profiled stretch's match kernel launches, in time order."""
    return [e for e in ctx.get("device", []) if MATCH_KERNEL in e[0]]
