"""Workload model: jobs, tasks, and trace containers.

A copy of ``Job``, ``Task``, ``Workload``, ``load_workload`` and
``save_workload`` from ``repro/workload/traces.py`` (the port imports
nothing of the reference); the two packages read each other's trace files.  Mirrors the paper's workload
abstraction (§2.1, Table 1): a job is a bag of tasks, each task needs one
scheduling unit (single-resource DC, §4.1), a job completes when its last
task completes (Eq. 1).
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass, field
from pathlib import Path
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


def load_workload(path: str | Path) -> Workload:
    """Load a workload from a CSV (``submit_time,dur1 dur2 ...``) or JSON file.

    The CSV format matches the Sparrow/Eagle simulator trace layout: one job
    per line, first column submission time, remaining a space-separated task
    duration list.
    """
    path = Path(path)
    jobs: list[Job] = []
    if path.suffix == ".json":
        data = json.loads(path.read_text())
        for i, j in enumerate(data["jobs"]):
            jobs.append(
                Job(
                    job_id=i,
                    submit_time=float(j["submit_time"]),
                    durations=[float(d) for d in j["durations"]],
                    estimated_duration=j.get("estimated_duration"),
                )
            )
    else:
        with path.open() as f:
            for i, row in enumerate(csv.reader(f)):
                if not row:
                    continue
                submit = float(row[0])
                durs = [float(x) for x in row[1].split()] if len(row) > 1 else []
                jobs.append(Job(job_id=i, submit_time=submit, durations=durs))
    return Workload(name=path.stem, jobs=jobs)


def save_workload(wl: Workload, path: str | Path) -> None:
    path = Path(path)
    payload = {
        "jobs": [
            {
                "submit_time": j.submit_time,
                "durations": list(j.durations),
                "estimated_duration": j.estimated_duration,
            }
            for j in wl.sorted_jobs()
        ]
    }
    path.write_text(json.dumps(payload))
