"""Synthetic and trace-like workload generators (paper Table 1).

A copy of the fixed-trace generators of ``repro/workload/synth.py``
(``synthetic_trace``, ``_pareto``, ``_trace_like``, ``yahoo_like_trace``,
``google_like_trace`` and ``downsampled``); the open-loop arrival
processes come with the streaming slice of the port.  Same seeds, same
``random.Random`` draws, so both packages build identical traces.

The real Yahoo/Google traces are not redistributable offline; these are
statistically matched surrogates from the published summary statistics.
All generators are seeded and deterministic.
"""

from __future__ import annotations

import random
from typing import Optional

from repro_torch.workload.traces import Job, Workload

# Fraction of jobs classified "long" and the duration scale separating the two
# classes.  Published trace analyses (Delgado et al., Eagle) report ~10% of
# jobs being long while consuming ~80%+ of resource-seconds; we match that.
LONG_JOB_FRACTION = 0.10
SHORT_MEAN = 0.5  # seconds
LONG_MEAN = 45.0  # seconds


def _pareto(rng: random.Random, mean: float, alpha: float = 1.8) -> float:
    # Pareto with finite mean: mean = xm * alpha / (alpha - 1)
    xm = mean * (alpha - 1.0) / alpha
    return min(xm * (1.0 - rng.random()) ** (-1.0 / alpha), mean * 50.0)


def synthetic_trace(
    num_jobs: int = 2000,
    tasks_per_job: int = 1000,
    task_duration: float = 1.0,
    load: float = 0.8,
    num_workers: int = 10_000,
    seed: int = 0,
    arrivals: str = "poisson",
) -> Workload:
    """The paper's synthetic trace: jobs of ``tasks_per_job`` fixed-duration
    tasks; inter-arrival times tuned so demand/capacity == ``load`` (Eq. 6).

    Load = (tasks_per_job * task_duration / IAT) / num_workers
      =>  mean IAT = tasks_per_job * task_duration / (load * num_workers)

    ``arrivals``: "poisson" draws exponential IATs with that mean (Table 1
    lists IATs "based on load"); "fixed" uses the constant worst-case IAT,
    which phase-locks all GMs and maximizes repartitioning pressure.
    """
    if not (0.0 < load <= 1.0):
        raise ValueError("the paper evaluates load in (0, 1] only (§4.1)")
    rng = random.Random(seed)
    iat = tasks_per_job * task_duration / (load * num_workers)
    jobs = []
    t = 0.0
    for i in range(num_jobs):
        jobs.append(
            Job(job_id=i, submit_time=t, durations=[task_duration] * tasks_per_job)
        )
        t += iat if arrivals == "fixed" else rng.expovariate(1.0 / iat)
    return Workload(name=f"synthetic_load{load:g}", jobs=jobs)


def _trace_like(
    name: str,
    num_jobs: int,
    total_tasks: int,
    load: float,
    num_workers: int,
    seed: int,
    long_fraction: float = LONG_JOB_FRACTION,
) -> Workload:
    rng = random.Random(seed)
    mean_tasks = total_tasks / num_jobs

    # Draw per-job task counts from a geometric-ish distribution with the
    # right mean; clamp to >= 1.
    counts = []
    remaining = total_tasks
    for i in range(num_jobs):
        left = num_jobs - i
        if left == 1:
            c = max(1, remaining)
        else:
            c = max(1, min(int(rng.expovariate(1.0 / mean_tasks)) + 1, remaining - (left - 1)))
        counts.append(c)
        remaining -= c

    # Durations: bimodal short/long mixture with Pareto tails.
    jobs: list[Job] = []
    demand = 0.0
    for i, c in enumerate(counts):
        is_long = rng.random() < long_fraction
        mean = LONG_MEAN if is_long else SHORT_MEAN
        durs = [max(0.05, _pareto(rng, mean)) for _ in range(c)]
        jobs.append(Job(job_id=i, submit_time=0.0, durations=durs))
        demand += sum(durs)

    # Arrivals: Poisson process with rate chosen to hit the target load over
    # the run: load = demand / (span * num_workers) => span = demand/(load*W).
    span = demand / (load * num_workers)
    lam = num_jobs / span
    t = 0.0
    order = list(range(num_jobs))
    rng.shuffle(order)  # decorrelate job size from arrival order
    for idx in order:
        jobs[idx].submit_time = t
        t += rng.expovariate(lam)
    jobs.sort(key=lambda j: j.submit_time)
    for new_id, j in enumerate(jobs):
        j.job_id = new_id
    return Workload(name=name, jobs=jobs)


def yahoo_like_trace(
    num_jobs: int = 24262,
    total_tasks: int = 968335,
    load: float = 0.8,
    num_workers: int = 3000,
    seed: int = 1,
) -> Workload:
    """Surrogate for the Yahoo cluster trace (Table 1; DC size 3000, §4.1)."""
    return _trace_like("yahoo_like", num_jobs, total_tasks, load, num_workers, seed)


def google_like_trace(
    num_jobs: int = 10000,
    total_tasks: int = 312558,
    load: float = 0.8,
    num_workers: int = 13000,
    seed: int = 2,
) -> Workload:
    """Surrogate for the Google cluster sub-trace (Table 1; DC size 13000)."""
    return _trace_like("google_like", num_jobs, total_tasks, load, num_workers, seed)


def downsampled(
    wl: Workload,
    factor: int = 100,
    mean_iat: float = 1.0,
    seed: int = 3,
    max_jobs: Optional[int] = None,
    thin_tasks: bool = True,
) -> Workload:
    """Down-sample a trace by ``factor`` and redraw arrivals ~ Exp(mean 1s),
    as done for the prototype runs (§4.2, Table 1 rows 4-5)."""
    rng = random.Random(seed)
    keep = [j for i, j in enumerate(wl.sorted_jobs()) if i % factor == 0]
    if max_jobs is not None:
        keep = keep[:max_jobs]
    t = 0.0
    jobs = []
    for new_id, j in enumerate(keep):
        # also thin very large jobs so task counts match Table 1's scale
        durs = list(
            j.durations[: max(1, len(j.durations) // factor)]
            if thin_tasks else j.durations
        )
        jobs.append(Job(job_id=new_id, submit_time=t, durations=durs))
        t += rng.expovariate(1.0 / mean_iat)
    return Workload(name=f"{wl.name}_ds{factor}", jobs=jobs)
