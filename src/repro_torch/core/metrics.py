"""Scheduler metrics: JCT / delay decomposition (paper §2.3.1, Eq. 1-5).

A copy of ``TaskRecord``, ``JobRecord``, ``RunMetrics``,
``PROVENANCE_COMPONENTS``, ``job_delay_decomposition``, ``percentile`` and
``classify_long`` from ``repro/core/metrics.py``, so the port's
``SimxRun.to_run_metrics`` builds the same records (and the same
``summary()``), and the event backend's delay breakdown is the same,
without importing the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class TaskRecord:
    job_id: int
    task_index: int
    duration: float          # IdealTET_{i,j}
    submit_time: float       # JST_i
    start_time: float = math.nan   # when the task began executing on a worker
    finish_time: float = math.nan  # TRT_{i,j}
    # Delay decomposition (Eq. 5); components a scheduler doesn't have stay 0.
    d_queue_scheduler: float = 0.0
    d_proc: float = 0.0
    d_comm: float = 0.0
    d_queue_worker: float = 0.0
    d_exec: float = 0.0
    # Lifecycle provenance, with continuous event times.  Schedulers that
    # never touch a field leave its default, which keeps the record valid.
    first_attempt_time: float = math.nan  # first scheduler attempt
    first_start_time: float = math.nan    # first launch (pre fault-rework)
    stale_retry_time: float = 0.0         # time burnt on stale-state retries
    stale_retries: int = 0
    requeues: int = 0
    placed_worker: int = -1
    placed_entity: int = -1               # scheduling authority of the launch

    @property
    def tct(self) -> float:
        """Task completion time (Eq. 3): TRT - JST."""
        return self.finish_time - self.submit_time

    @property
    def delay(self) -> float:
        """d^task (Eq. 4): TCT - IdealTET."""
        return self.tct - self.duration

    def decomposition_residual(self) -> float:
        """|delay - sum(components)| — should be ~0 for a correct accounting."""
        s = (
            self.d_queue_scheduler
            + self.d_proc
            + self.d_comm
            + self.d_queue_worker
            + self.d_exec
        )
        return abs(self.delay - s)


@dataclass
class JobRecord:
    job_id: int
    submit_time: float
    ideal_jct: float
    num_tasks: int
    finish_time: float = math.nan  # JRT_i
    is_long: bool = False

    @property
    def jct(self) -> float:
        """Eq. 1: JRT - JST."""
        return self.finish_time - self.submit_time

    @property
    def delay(self) -> float:
        """Eq. 2: JCT - IdealJCT."""
        return self.jct - self.ideal_jct


@dataclass
class RunMetrics:
    scheduler: str
    workload: str
    jobs: list[JobRecord] = field(default_factory=list)
    tasks: list[TaskRecord] = field(default_factory=list)
    # Megha-specific counters (Fig. 2b)
    inconsistencies: int = 0
    repartitions: int = 0
    # generic counters
    messages: int = 0
    probes: int = 0

    @property
    def inconsistency_ratio(self) -> float:
        """Inconsistency events per task request (Fig. 2b)."""
        return self.inconsistencies / max(1, len(self.tasks))

    def overhead_summary(self) -> dict:
        """The control-plane overhead counters as one dict."""
        return {
            "messages": self.messages,
            "probes": self.probes,
            "inconsistencies": self.inconsistencies,
            "inconsistency_rate": self.inconsistency_ratio,
        }

    def job_delays(self, long: Optional[bool] = None) -> list[float]:
        return [
            j.delay
            for j in self.jobs
            if not math.isnan(j.finish_time) and (long is None or j.is_long == long)
        ]

    def summary(self) -> dict:
        out = {
            "scheduler": self.scheduler,
            "workload": self.workload,
            "jobs": len(self.jobs),
            "tasks": len(self.tasks),
            "inconsistency_ratio": self.inconsistency_ratio,
            "repartitions": self.repartitions,
            "messages": self.messages,
            "probes": self.probes,
        }
        for cls, name in ((None, "all"), (False, "short"), (True, "long")):
            d = self.job_delays(cls)
            out[f"{name}_median_delay"] = percentile(d, 50)
            out[f"{name}_p95_delay"] = percentile(d, 95)
            out[f"{name}_mean_delay"] = sum(d) / len(d) if d else math.nan
        return out


#: the four provenance components, matching ``repro_torch.simx.provenance.COMPONENTS``
PROVENANCE_COMPONENTS = (
    "eligible_wait",
    "placement_wait",
    "inconsistency_retry",
    "fault_rework",
)


def job_delay_decomposition(metrics: RunMetrics) -> dict:
    """Split each finished job's Eq. 2 delay into the four provenance
    components — the event-backend mirror of
    ``repro_torch.simx.provenance.decompose_delays``, with continuous event
    times where simx counts rounds.

    Per job the attribution follows its critical (last-finishing) task,
    ties broken to the highest task index:

      * ``eligible_wait``       — submit -> the critical task's first
        scheduler attempt, anchored inside [submit, start].
      * ``inconsistency_retry`` — its accumulated ``stale_retry_time``.
      * ``fault_rework``        — final start - first start (re-runs).
      * ``placement_wait``      — the residual.

    Retry and rework are clipped into the remaining budget in sequence, so
    the components telescope exactly to the job delay.  Returns one list
    per key, aligned with ``metrics.jobs`` (NaN for unfinished jobs)."""
    by_job: dict[int, list[TaskRecord]] = {}
    for tr in metrics.tasks:
        by_job.setdefault(tr.job_id, []).append(tr)
    out: dict[str, list[float]] = {
        k: [] for k in ("delays",) + PROVENANCE_COMPONENTS
    }
    for j in metrics.jobs:
        trs = by_job.get(j.job_id, [])
        if math.isnan(j.finish_time) or not trs:
            for k in out:
                out[k].append(math.nan)
            continue
        fmax = max(t.finish_time for t in trs)
        ci = max(
            (t for t in trs if t.finish_time == fmax),
            key=lambda t: t.task_index,
        )
        d = j.delay
        start = ci.finish_time - ci.duration
        submit = ci.submit_time
        attempt = submit if math.isnan(ci.first_attempt_time) else ci.first_attempt_time
        anchor = min(max(attempt, submit), max(start, submit))
        eligible = min(max(anchor - submit, 0.0), d)
        retry = min(max(ci.stale_retry_time, 0.0), d - eligible)
        first_start = (
            start if math.isnan(ci.first_start_time) else ci.first_start_time
        )
        rework = min(max(start - first_start, 0.0), d - eligible - retry)
        out["delays"].append(d)
        out["eligible_wait"].append(eligible)
        out["inconsistency_retry"].append(retry)
        out["fault_rework"].append(rework)
        out["placement_wait"].append(d - (eligible + retry + rework))
    return out


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (numpy 'linear' method)."""
    if not xs:
        return math.nan
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    k = (len(s) - 1) * p / 100.0
    lo = int(math.floor(k))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def classify_long(estimated_duration: float, threshold: float) -> bool:
    """Eagle-style job classification by estimated runtime (§2.2.3)."""
    return estimated_duration >= threshold
