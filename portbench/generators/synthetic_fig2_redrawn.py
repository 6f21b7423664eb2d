"""The paper's synthetic trace with the arrivals redrawn for every row.

The same jobs, tasks, arrival law and mean gaps as ``synthetic_fig2``, whose
``unit_arrivals`` and ``mean_gap`` it calls unchanged; the one difference is
where the unit arrivals come from.  ``synthetic_fig2`` draws one set from
``seed`` and scales it to every load, so that rows differ only by their
load.  Here row ``i`` of ``loads`` draws its own set from ``seed + i`` and
scales it to its load, so a load listed several times gives as many
different draws of its arrivals: the spread of a curve's points for a rule
that draws no random numbers of its own, whose scheduler seeds would all run
the same point.  Row 0 is ``synthetic_fig2``'s row 0.  ``poisson_fixed_span``
still gives every row of one load the same span, so every seed of the cell
has the same round budget and the same number of rounds.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import load_part

_BASE = load_part("generators", "synthetic_fig2")


def trace(cfg: dict, traffic: dict, seed: int) -> dict:
    """``num_jobs`` jobs of ``tasks_per_job`` tasks of ``task_duration``
    seconds; row ``i`` arrives by ``arrivals`` at ``loads[i]``, its unit
    arrivals drawn from ``seed + i``."""
    J, n = int(traffic["num_jobs"]), int(traffic["tasks_per_job"])
    dur = float(traffic["task_duration"])
    rows = [(_BASE.unit_arrivals(seed + i, J, traffic["arrivals"])
             * _BASE.mean_gap(load, n, dur, cfg["num_workers"])).astype(np.float32)
            for i, load in enumerate(traffic["loads"])]
    return dict(
        job=np.repeat(np.arange(J, dtype=np.int32), n),
        duration=np.full(J * n, dur, np.float32),
        job_ntasks=np.full(J, n, np.int32),
        job_submit=np.stack(rows),
    )
