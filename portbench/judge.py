"""How ``correct`` is decided: the program's outputs against the plain
reference's, number by number, each held to a limit of its own.

The numbers, each the widest over what it compares:

* ``finish_gap_s``: |program - reference| of every task's finish time, over
  the points the reference checks (a task that one side never finished and
  the other did reads inf).  Exact: both sides do the same float32 sums.
* ``count_gap``: |program - reference| of every count of ``point_summary``
  (tasks and jobs done, messages, probes, inconsistencies, lost tasks,
  reservation overflows, insertion lag), at the checked points of every
  grid of the window (the grids of a run share their inputs).  Exact.
* ``delay_gap_s``: |program - reference| of the p50, p95 and mean job delay
  (Eq. 2) at the checked points of every grid, the reference's taken in
  float64 from its own finish times; nan on one side only reads inf.
* ``util_gap``: |program - reference| of the mean worker utilisation, the
  same way.
* ``tasks_left``: tasks not finished at the end, over every point of every
  grid of the window: the configuration guarantees that every task
  completes.

Task finish times are kept of the last grid only (a grid's state is freed
before the next one starts).

The limits sit in ``portbench/checks/<cell>.json`` beside the number of
points the reference checks.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

#: point_summary columns that are counts (compared exactly)
COUNTS = ("tasks_done", "jobs_done", "messages", "probes", "inconsistencies", "lost",
          "res_overflow", "probe_lag")
#: point_summary columns of seconds
DELAYS = ("p50", "p95", "mean")
NUMBERS = ("finish_gap_s", "count_gap", "delay_gap_s", "util_gap", "tasks_left")


def _gap(a, b) -> float:
    """Widest |a - b| over two arrays, where equal values (inf and nan
    included) read 0 and a nan or inf against anything else reads inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0.0
    d = np.abs(a[~same] - b[~same])
    d[~np.isfinite(d)] = math.inf
    return float(d.max())


def summarize(task_finish: np.ndarray, t: np.ndarray, counters: dict, job: np.ndarray,
              duration: np.ndarray, job_submit: np.ndarray, num_workers: int) -> dict:
    """The reference's own ``point_summary`` columns, in float64, for K
    points: ``task_finish [K, T]``, ``t [K]``, ``job_submit [K, J]``."""
    tf = task_finish.astype(np.float64)
    t = t.astype(np.float64)[:, None]
    dur = duration.astype(np.float64)
    K, J = job_submit.shape
    done = tf <= t
    fin = np.where(done, tf, math.inf)
    # tasks are stored job by job: reduce each job's contiguous run
    starts = np.flatnonzero(np.r_[True, job[1:] != job[:-1]])
    ids = job[starts]
    job_finish = np.full((K, J), -math.inf)
    job_finish[:, ids] = np.maximum.reduceat(fin, starts, axis=1)
    ideal = np.full(J, -math.inf)
    ideal[ids] = np.maximum.reduceat(dur, starts)
    delays = np.where(np.isfinite(job_finish),
                      job_finish - job_submit.astype(np.float64) - ideal, np.nan)
    busy = np.clip(np.minimum(tf, t) - (tf - dur), 0.0, dur)
    out = {
        "tasks_done": done.sum(-1),
        "jobs_done": np.isfinite(job_finish).sum(-1),
        "mean_util": busy.sum(-1) / (num_workers * np.maximum(t[:, 0], 1e-9)),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # a point with no finished job
        out["p50"] = np.nanquantile(delays, 0.5, axis=-1)
        out["p95"] = np.nanquantile(delays, 0.95, axis=-1)
        out["mean"] = np.nanmean(delays, axis=-1)
    for key in COUNTS:
        if key not in out:
            out[key] = np.asarray(counters[key])
    return out


def numbers(grids: list[dict], checked: list[int], port_finish: np.ndarray,
            ref_finish: np.ndarray, ref_summary: dict, num_tasks: int) -> dict:
    """Every compared number of one run.

    ``grids``: each grid's summary (``point_summary`` columns, numpy, one
    value per point), read at the ``checked`` points; ``port_finish [K, T]``
    the last grid's finish times there; against the reference's
    ``ref_finish`` and ``ref_summary``."""
    def widest(keys):
        return max(_gap(g[k][checked], ref_summary[k]) for g in grids for k in keys)

    return {
        "finish_gap_s": _gap(port_finish, ref_finish),
        "count_gap": widest(COUNTS),
        "delay_gap_s": widest(DELAYS),
        "util_gap": widest(("mean_util",)),
        "tasks_left": float(sum(int(num_tasks * g["tasks_done"].size
                                    - g["tasks_done"].astype(np.int64).sum())
                                for g in grids)),
    }


def failed_points(grids: list[dict], num_tasks: int, checked: list[int],
                  port_finish: np.ndarray, ref_finish: np.ndarray) -> int:
    """Points whose answer is wrong: unfinished tasks in any grid, or a
    checked point whose finish times differ from the reference's."""
    bad = 0
    for g in grids:
        bad += int((g["tasks_done"] != num_tasks).sum())
    for i in range(len(checked)):
        if _gap(port_finish[i], ref_finish[i]) != 0.0:
            bad += 1
    return bad


def verdict(values: dict, limits: dict) -> tuple[bool, list[str]]:
    """``correct`` and one line per number: its value beside its limit."""
    lines, ok = [], True
    for name in NUMBERS:
        v, lim = values[name], limits[name]
        good = v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    return ok, lines
