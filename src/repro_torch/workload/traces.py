"""Workload model: jobs, tasks, and trace containers.

A copy of ``Job``, ``Task`` and ``Workload`` from ``repro/workload/traces.py``
(the port imports nothing of the reference).  Mirrors the paper's workload
abstraction (§2.1, Table 1): a job is a bag of tasks, each task needs one
scheduling unit (single-resource DC, §4.1), a job completes when its last
task completes (Eq. 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence


@dataclass
class Task:
    job_id: int
    index: int
    duration: float  # IdealTET — ideal execution time on an unloaded worker

    @property
    def key(self) -> tuple[int, int]:
        return (self.job_id, self.index)


@dataclass
class Job:
    job_id: int
    submit_time: float  # JST
    durations: Sequence[float]
    # Estimated runtime, available to estimate-based schedulers (Eagle).
    # Defaults to the true max duration (the paper: "many jobs are recurring
    # ... easier to estimate job duration from previous runs").
    estimated_duration: Optional[float] = None

    def __post_init__(self) -> None:
        if self.estimated_duration is None:
            self.estimated_duration = max(self.durations) if len(self.durations) else 0.0

    @property
    def num_tasks(self) -> int:
        return len(self.durations)

    @property
    def ideal_jct(self) -> float:
        """JCT under an omniscient scheduler on an infinite DC (Eq. 2)."""
        return max(self.durations) if len(self.durations) else 0.0

    def tasks(self) -> Iterator[Task]:
        for i, d in enumerate(self.durations):
            yield Task(self.job_id, i, d)


@dataclass
class Workload:
    name: str
    jobs: list[Job] = field(default_factory=list)

    @property
    def num_jobs(self) -> int:
        return len(self.jobs)

    @property
    def num_tasks(self) -> int:
        return sum(j.num_tasks for j in self.jobs)

    @property
    def makespan_demand(self) -> float:
        """Total resource-seconds demanded."""
        return sum(sum(j.durations) for j in self.jobs)

    def sorted_jobs(self) -> list[Job]:
        return sorted(self.jobs, key=lambda j: (j.submit_time, j.job_id))

    def stats(self) -> dict:
        durs = [d for j in self.jobs for d in j.durations]
        iats = [
            b.submit_time - a.submit_time
            for a, b in zip(self.sorted_jobs(), self.sorted_jobs()[1:])
        ]
        return {
            "name": self.name,
            "num_jobs": self.num_jobs,
            "num_tasks": self.num_tasks,
            "mean_task_duration": sum(durs) / max(1, len(durs)),
            "mean_iat": sum(iats) / max(1, len(iats)) if iats else 0.0,
            "demand_resource_seconds": self.makespan_demand,
        }
