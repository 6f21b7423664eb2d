"""round_ms: wall ms a round of ``runtime.scan_rounds``, over the traced
run's grids (the profiled and replayed stretch left out), host clock ending
in a synchronize."""


def read(ctx):
    rounds = sum(ctx.get("scan_rounds", []))
    if not rounds:
        return None
    return 1e3 * sum(ctx["scan_s"]) / rounds
