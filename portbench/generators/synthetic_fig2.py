"""The paper's synthetic trace (Megha, arXiv:2308.10178, Table 1 and Eq. 6).

Jobs of ``tasks_per_job`` tasks of ``task_duration`` seconds, Poisson
arrivals whose mean gap is

    iat = tasks_per_job * task_duration / (load * num_workers),

one set of unit gaps drawn from the seed with ``random.Random(seed)`` and
scaled by each load's ``iat``, as ``workload/synth.py::synthetic_trace`` of
the repository does, with one difference: the arrival law
``poisson_fixed_span`` conditions the Poisson process on its span.  The unit
gaps are rescaled so that the last job arrives at exactly ``(num_jobs - 1) *
iat``.  The points of a Poisson process given their count and span are
uniform over the span, so the arrivals stay Poisson, while every seed gets
the same span, the same round budget and so the same number of rounds.
"""

from __future__ import annotations

import random

import numpy as np

ARRIVALS = ("poisson_fixed_span",)


def unit_arrivals(seed: int, num_jobs: int, arrivals: str) -> np.ndarray:
    """float64[num_jobs] arrival times in units of the mean gap, the first
    job at 0."""
    if arrivals not in ARRIVALS:
        raise ValueError(f"arrivals must be one of {ARRIVALS}, got {arrivals!r}")
    rng = random.Random(seed)
    gaps = np.array([rng.expovariate(1.0) for _ in range(num_jobs - 1)], np.float64)
    out = np.zeros(num_jobs, np.float64)
    if num_jobs > 1:
        out[1:] = np.cumsum(gaps)
        out *= (num_jobs - 1) / out[-1]
        out[-1] = num_jobs - 1
    return out


def mean_gap(load: float, tasks_per_job: int, task_duration: float, num_workers: int) -> float:
    """Eq. 6: the mean inter-arrival time that makes demand / capacity ==
    ``load``."""
    if not 0.0 < load <= 1.0:
        raise ValueError("the paper evaluates load in (0, 1] only (§4.1)")
    return tasks_per_job * task_duration / (load * num_workers)


def trace(cfg: dict, traffic: dict, seed: int) -> dict:
    """``num_jobs`` jobs of ``tasks_per_job`` tasks of ``task_duration``
    seconds, arriving by ``arrivals`` at each of ``loads``."""
    J, n = int(traffic["num_jobs"]), int(traffic["tasks_per_job"])
    dur = float(traffic["task_duration"])
    unit = unit_arrivals(seed, J, traffic["arrivals"])
    return dict(
        job=np.repeat(np.arange(J, dtype=np.int32), n),
        duration=np.full(J * n, dur, np.float32),
        job_ntasks=np.full(J, n, np.int32),
        job_submit=np.stack([(unit * mean_gap(load, n, dur, cfg["num_workers"]))
                             .astype(np.float32) for load in traffic["loads"]]),
    )
