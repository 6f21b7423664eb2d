"""sim_tasks_per_s: simulated tasks completed (every point of every grid of
the window) over the wall time of those grids, host clock, each grid from
its start to its summaries on the host after a synchronize."""


def read(ctx):
    walls = ctx.get("grid_walls")
    if not walls:
        return None
    return sum(ctx["grid_tasks"]) / sum(walls)
