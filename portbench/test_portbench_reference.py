"""The plain references agree with the program's plain path on a tiny grid
on the CPU, bitwise in every task's finish time and every count: every rule
of the manifest (``cpu_cells.CELLS``) as its first cell states it, and some
rules again with configuration keys changed to reach a path that cell
leaves quiet."""

import pytest

from portbench.cpu_cells import CELLS, run_tiny, tiny

#: further cases of a rule, each a change of its configuration
MORE = {
    "sparrow": [
        # queues of 2 slots: probes dropped, orphans rescued
        {"reserve_cap": 2},
        # a 300-probe insertion window that the arrivals outrun
        {"reserve_cap": 3, "probe_window": 300},
    ],
    # every job long (its 1 s tasks at or above the threshold): the low
    # FIFOs alone, the reserved workers left idle
    "pigeon": [{"long_threshold": 0.5}],
}


@pytest.mark.parametrize("rule, cfg", [
    (rule, cfg) for rule in CELLS for cfg in [{}] + MORE.get(rule, [])])
def test_reference_matches_the_program(rule, cfg):
    run = run_tiny(tiny(rule, **cfg))
    v = run.values
    assert v["finish_gap_s"] == 0.0 and v["count_gap"] == 0.0 and v["tasks_left"] == 0.0
    assert v["delay_gap_s"] < 1e-5 and v["util_gap"] < 1e-6
    assert run.correct and run.failed == 0
    last = run.grids[-1]
    if "reserve_cap" in cfg:
        assert last["res_overflow"].sum() > 0
    if "probe_window" in cfg:
        assert last["probe_lag"].sum() > 0
    if rule == "megha":
        assert last["inconsistencies"].sum() > 0     # stale views proposed
