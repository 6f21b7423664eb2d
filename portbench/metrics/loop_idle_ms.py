"""loop_idle_ms: device-idle ms a round that the round loop leaves, between
the profiled stretch's first and last device op: every gap of the busy
union that starts inside a host-read span of the program (the read's drain
and refill), and every gap whose midpoint lies outside the program's
``simx.dispatch`` span (the runtime's stages, the Python loop, between
rounds).  With ``step_idle_ms`` it makes up that idle time whole."""

from portbench.program_spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    if split is None:
        return None
    return 1e3 * split[1] / ctx["stretch_rounds"]
