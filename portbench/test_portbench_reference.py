"""The plain references agree with the program's plain path on a tiny grid
on the CPU, bitwise in every task's finish time and every count."""

import pytest

from portbench.cpu_cells import run_tiny, tiny


@pytest.mark.parametrize("rule, cfg", [
    ("megha", {}),
    ("sparrow", {}),
    # queues of 2 slots: probes dropped, orphans rescued
    ("sparrow", {"reserve_cap": 2}),
    # a 300-probe insertion window that the arrivals outrun
    ("sparrow", {"reserve_cap": 3, "probe_window": 300}),
])
def test_reference_matches_the_program(rule, cfg):
    run = run_tiny(tiny(rule, **cfg))
    v = run.values
    assert v["finish_gap_s"] == 0.0 and v["count_gap"] == 0.0 and v["tasks_left"] == 0.0
    assert v["delay_gap_s"] < 1e-5 and v["util_gap"] < 1e-6
    assert run.correct and run.failed == 0
    last = run.grids[-1]
    if cfg:
        assert last["res_overflow"].sum() > 0
    if "probe_window" in cfg:
        assert last["probe_lag"].sum() > 0
    if rule == "megha":
        assert last["inconsistencies"].sum() > 0     # stale views proposed
