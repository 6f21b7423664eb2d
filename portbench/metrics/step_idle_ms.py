"""step_idle_ms: device-idle ms a round that the rule step leaves, between
the profiled stretch's first and last device op: every gap of the busy
union whose midpoint lies inside the program's ``simx.dispatch`` span or a
span inside it, unless the gap starts inside a host-read span (those go to
``loop_idle_ms``)."""

from portbench.program_spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    if split is None:
        return None
    return 1e3 * split[0] / ctx["stretch_rounds"]
