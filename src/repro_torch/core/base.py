"""Common scheduler interface for the discrete-event simulation.

A copy of ``repro/core/base.py`` (``LONG_JOB_THRESHOLD``, ``JobState``,
``Scheduler``) plus ``grid_workers`` from ``repro/core/megha.py``, so the
port imports nothing of ``repro``.

Every architecture implements ``Scheduler``: the harness pushes
``submit(job)`` events at each job's submission time and drains the loop.
All delay accounting flows into a shared ``RunMetrics``.

Hop accounting convention (matches the paper's 0.5 ms constant-delay model,
§4.1, and reproduces the observed 0.0015 s uncontended Megha median = 3 hops):

    client -> scheduling entity     : 1 hop
    entity -> entity (GM->LM etc.)  : 1 hop each
    final entity -> worker (launch) : 1 hop
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.events import NETWORK_DELAY, EventLoop
from repro_torch.core.metrics import JobRecord, RunMetrics, TaskRecord, classify_long
from repro_torch.workload.traces import Job

#: Default threshold (seconds of estimated runtime) separating short and long
#: jobs for estimate-based schedulers and for reporting (Fig. 3c/3d).
#: Copied from ``repro/core/base.py`` (``LONG_JOB_THRESHOLD``).
LONG_JOB_THRESHOLD = 10.0


def grid_workers(num_workers: int, num_gms: int, num_lms: int) -> int:
    """Shave the worker count so the GM x LM partition grid divides evenly
    — the one rule shared by every Megha construction site.  Copied from
    ``repro/core/megha.py`` (``grid_workers``)."""
    per = num_workers // (num_gms * num_lms)
    return per * num_gms * num_lms


@dataclass
class JobState:
    """Scheduler-side bookkeeping for one job."""

    job: Job
    arrival_time: float                     # when the scheduling entity saw it
    record: JobRecord = field(init=False)
    pending: list[int] = field(init=False)  # task indices not yet launched
    running: int = 0
    completed: int = 0
    task_records: dict[int, TaskRecord] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.record = JobRecord(
            job_id=self.job.job_id,
            submit_time=self.job.submit_time,
            ideal_jct=self.job.ideal_jct,
            num_tasks=self.job.num_tasks,
            is_long=classify_long(self.job.estimated_duration, LONG_JOB_THRESHOLD),
        )
        self.pending = list(range(self.job.num_tasks))
        for i, d in enumerate(self.job.durations):
            self.task_records[i] = TaskRecord(
                job_id=self.job.job_id,
                task_index=i,
                duration=d,
                submit_time=self.job.submit_time,
            )

    @property
    def done(self) -> bool:
        return self.completed == self.job.num_tasks


class Scheduler:
    """Base class; subclasses implement ``submit``."""

    name = "base"

    def __init__(self, loop: EventLoop, metrics: RunMetrics) -> None:
        self.loop = loop
        self.metrics = metrics
        self.hop = NETWORK_DELAY

    def submit(self, job: Job) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    # -- shared bookkeeping helpers -------------------------------------
    def _finish_task(self, js: JobState, task_index: int, finish_time: float) -> None:
        tr = js.task_records[task_index]
        tr.finish_time = finish_time
        js.running -= 1
        js.completed += 1
        if js.done:
            js.record.finish_time = finish_time
        # Eq. 5 with overlap resolution (§2.3.1: "the delays overlap, and
        # cannot be blindly aggregated").  Pre-start delay is authoritative:
        # queued-at-scheduler time that elapsed *during* message round trips
        # is clipped from d_queue_scheduler first, then from d_comm.
        if not math.isnan(tr.start_time):
            pre = max(0.0, tr.start_time - tr.submit_time)
            known = tr.d_queue_scheduler + tr.d_proc + tr.d_comm + tr.d_queue_worker
            over = known - pre
            if over > 1e-15:
                take = min(over, tr.d_queue_scheduler)
                tr.d_queue_scheduler -= take
                over -= take
                if over > 0:
                    take = min(over, tr.d_queue_worker)
                    tr.d_queue_worker -= take
                    over -= take
                tr.d_comm = max(0.0, tr.d_comm - over)
        # attribute anything still unexplained to worker-side queuing (the
        # only remaining overlapping component)
        resid = tr.delay - (
            tr.d_queue_scheduler + tr.d_proc + tr.d_comm + tr.d_queue_worker + tr.d_exec
        )
        if resid > 1e-12:
            tr.d_queue_worker += resid

    def _register(self, js: JobState) -> None:
        self.metrics.jobs.append(js.record)
        self.metrics.tasks.extend(js.task_records.values())
