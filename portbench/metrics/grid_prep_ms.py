"""grid_prep_ms: host ms a grid spends outside its rounds: ``build_grid``
(the seeds' draws per point, the step built, the state made) and
``point_summary`` read back to the host; the benchmark's own spans, each
ending in a synchronize, averaged over the traced run's grids."""


def read(ctx):
    spans = ctx.get("grid_prep_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
