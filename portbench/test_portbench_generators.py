"""``synthetic_fig2_redrawn``: row ``i`` of the loads draws its own arrivals
from ``seed + i``, so rows of one load differ, while every row keeps the
span its load gives and row 0 is ``synthetic_fig2``'s row 0."""

import numpy as np
import pytest

from portbench import traffic

MIX = dict(num_jobs=12, tasks_per_job=96, task_duration=1.0, arrivals="poisson_fixed_span",
           slack=4.0, loads=[0.6, 0.6, 0.6, 0.95, 0.95], scheduler_seeds=1)
CFG = dict(num_workers=640, dt=0.05, heartbeat_interval=5.0)


def _trace(name, seed):
    return traffic.load_part("generators", name).trace(CFG, MIX, seed)


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_rows_of_one_load_differ_and_keep_its_span(seed):
    rows = _trace("synthetic_fig2_redrawn", seed)["job_submit"]
    assert rows.shape == (5, 12) and rows.dtype == np.float32
    for i, load in enumerate(MIX["loads"]):
        gap = 96 * 1.0 / (load * CFG["num_workers"])
        assert rows[i, 0] == 0.0 and np.all(np.diff(rows[i]) >= 0)
        assert rows[i, -1] == np.float32(11 * gap)
    for a, b in ((0, 1), (0, 2), (1, 2), (3, 4)):
        assert not np.array_equal(rows[a], rows[b])
    # row i is synthetic_fig2's draw from seed + i, at its own load
    base = _trace("synthetic_fig2", seed)
    assert np.array_equal(rows[0], base["job_submit"][0])
    shifted = _trace("synthetic_fig2", seed + 3)["job_submit"][3]
    assert np.array_equal(rows[3], shifted)
    for key in ("job", "duration", "job_ntasks"):
        assert np.array_equal(_trace("synthetic_fig2_redrawn", seed)[key], base[key])


def test_every_seed_has_the_same_rounds():
    budgets = {traffic.build(dict(CFG, scheduler="pigeon"),
                             dict(MIX, generator="synthetic_fig2_redrawn"), seed,
                             "cpu").num_rounds
               for seed in (1, 99, 2**31 + 5)}
    assert len(budgets) == 1
