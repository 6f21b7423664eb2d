"""step_kernels: kernels launched a round in the profiled stretch (copies
and sets not counted)."""

from portbench.devtrace import is_kernel


def read(ctx):
    kernels = [e for e in ctx.get("device", []) if is_kernel(e[0])]
    if not kernels:
        return None
    return len(kernels) / ctx["stretch_rounds"]
