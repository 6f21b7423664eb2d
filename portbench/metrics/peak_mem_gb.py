"""peak_mem_gb: ``torch.cuda.max_memory_allocated`` over the window, the
peak statistics reset as it opens (GB = 1e9 bytes)."""


def read(ctx):
    if not ctx.get("on_card"):
        return None
    return ctx["peak_bytes"] / 1e9
