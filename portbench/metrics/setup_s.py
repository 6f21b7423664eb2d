"""setup_s: host clock from process start to the first timed grid: imports,
CUDA init, loading the kernel library, building the inputs, the warm-up."""


def read(ctx):
    return ctx.get("setup_s")
