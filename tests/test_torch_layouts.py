"""The FIFO row builder every queueing rule's layout comes from
(``repro_torch.simx.state.fifo_rows``), held to a plain per-row loop, and
pigeon's fixed-trace step, whose two class FIFOs it builds, held bitwise
to the reference's on a trace where both classes hold tasks."""

import dataclasses

import numpy as np
import pytest

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import export_workload as jax_export_workload
from repro.simx import faults as jax_faults
from repro.simx import pigeon as jax_pigeon
from repro.simx import runtime as jax_rt
from repro.workload import traces as jax_traces
from repro_torch.simx import SimxConfig, convert, pigeon
from repro_torch.simx import runtime as rt
from repro_torch.simx.faults import empty_schedule
from repro_torch.simx.state import export_workload, fifo_rows
from repro_torch.workload import traces


def _loop_rows(task_row: np.ndarray, n_rows: int, width: int, sentinel: int):
    """The rows one ``np.nonzero`` per row at a time."""
    rows = np.full((n_rows, width), sentinel, np.int32)
    lens = np.zeros(n_rows, np.int32)
    pos = np.zeros(task_row.size, np.int32)
    for r in range(n_rows):
        mine = np.nonzero(task_row == r)[0]
        rows[r, : mine.size] = mine
        lens[r] = mine.size
        pos[mine] = np.arange(mine.size)
    return rows, lens, pos


_RNG = np.random.default_rng(11)
ASSIGNMENTS = {
    # rows 0, 2, 3 and 5 hold nothing
    "empty_rows": (np.array([1, 4, 4, 1, -1, 4, 1, 1]), 6),
    # a class with no task: every slot in no row
    "no_task": (np.full(9, -1), 4),
    "one_row": (np.array([0, -1, 0, 0, -1, -1, 0]), 1),
    "equal_rows": (np.arange(20) % 4, 4),
    "random": (_RNG.integers(-1, 7, size=500), 7),
}


@pytest.mark.parametrize("case", list(ASSIGNMENTS))
def test_fifo_rows_match_a_per_row_loop(case):
    task_row, n_rows = ASSIGNMENTS[case]
    T = task_row.size
    width = int(np.bincount(task_row[task_row >= 0], minlength=n_rows).max()) + 3
    got = fifo_rows(task_row, n_rows, width, T)
    for name, g, w in zip(("rows", "lens", "pos"), got, _loop_rows(task_row, n_rows, width, T)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _two_class_trace(m):
    """12 jobs, 0.2 s apart, on module ``m``'s ``Job`` / ``Workload``:
    every third 6 tasks of 3 s, the rest 10 tasks of 0.5 s, so a 2 s
    ``long_threshold`` puts tasks in both of pigeon's class FIFOs."""
    jobs = [m.Job(job_id=i, submit_time=0.2 * i,
                  durations=[3.0] * 6 if i % 3 == 0 else [0.5] * 10) for i in range(12)]
    return m.Workload(name="two_class", jobs=jobs)


@pytest.mark.parametrize("faults", ["none", "empty"])
def test_fixed_pigeon_with_both_classes_is_bitwise_the_reference(faults):
    """The fixed pigeon step (its layout built by ``pigeon_layout``) run
    ``rounds`` rounds, without a fault schedule and with an empty one (the
    fault path's rollback positions come from the builder too), equals the
    reference's ``make_pigeon_step`` field by field."""
    kw = dict(num_workers=60, group_size=12, reserved_per_group=2, long_threshold=2.0,
              dt=0.05)
    rounds = 160
    jcfg, cfg = JaxSimxConfig(**kw), SimxConfig(**kw)
    jtasks = jax_export_workload(_two_class_trace(jax_traces))
    tasks = export_workload(_two_class_trace(traces), "cpu")
    jfs = None if faults == "none" else jax_faults.empty_schedule(60, jcfg.num_gms)
    fs = None if faults == "none" else empty_schedule(60, cfg.num_gms)
    want = jax_rt.scan_rounds(jax_pigeon.make_pigeon_step(jcfg, jtasks, faults=jfs),
                              jax_rt.get_rule("pigeon").init(jcfg, jtasks), rounds)
    got = rt.scan_rounds(pigeon.make_pigeon_step(cfg, tasks, faults=fs),
                         rt.batch_state(rt.get_rule("pigeon").init(cfg, tasks)), rounds)
    got = {k: v[0] for k, v in convert.state_to_numpy(got).items()}
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        assert got[f.name].dtype == w.dtype, f.name
        np.testing.assert_array_equal(got[f.name], w, err_msg=f.name)
    high = tasks.job_est[tasks.job.long()] < cfg.long_threshold
    assert 0 < int(high.sum()) < tasks.num_tasks           # both FIFOs hold tasks
    assert got["high_head"].sum() > 0 and got["low_head"].sum() > 0
    assert np.all(np.isfinite(got["task_finish"]))          # the trace drained
