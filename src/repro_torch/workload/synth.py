"""Synthetic and trace-like workload generators (paper Table 1).

A copy of ``repro/workload/synth.py``: the fixed-trace generators
(``synthetic_trace``, ``_pareto``, ``_trace_like``, ``yahoo_like_trace``,
``google_like_trace`` and ``downsampled``) and the open-loop arrival
processes that drive the streaming engine (``repro_torch.simx.stream``):
``ArrivalProcess`` with ``PoissonArrivals``, ``MMPPArrivals``,
``DiurnalArrivals``, ``PhasedArrivals`` and ``ReplayArrivals``, and the
job factories ``fixed_job_factory`` and ``bimodal_job_factory``.  Same
seeds, same ``random.Random`` draws, so both packages build identical
traces and job streams.  ``MMPPArrivals`` is copied as it is, with the
reference's known fault (an MMPP of equal rates is not the Poisson process
of that rate; ROADMAP queue 3).

The real Yahoo/Google traces are not redistributable offline; these are
statistically matched surrogates from the published summary statistics.
All generators are seeded and deterministic.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Iterator, Optional, Sequence

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


# ---------------------------------------------------------------------------
# open-loop arrival processes (the streaming steady-state engine)
# ---------------------------------------------------------------------------

#: (rng, job_index) -> task duration list.  Every arrival process draws its
#: job *shapes* through one of these so the arrival dynamics and the job
#: mixture stay independently configurable.
JobFactory = Callable[[random.Random, int], Sequence[float]]


def fixed_job_factory(
    tasks_per_job: int = 16, task_duration: float = 1.0
) -> JobFactory:
    """The paper's synthetic job shape: ``tasks_per_job`` fixed-duration
    tasks (deterministic, so the offered load is exact)."""

    def factory(rng: random.Random, i: int) -> Sequence[float]:
        del rng, i
        return [task_duration] * tasks_per_job

    return factory


def bimodal_job_factory(
    tasks_per_job: int = 16,
    long_fraction: float = LONG_JOB_FRACTION,
    short_mean: float = SHORT_MEAN,
    long_mean: float = LONG_MEAN,
) -> JobFactory:
    """Trace-like short/long mixture with Pareto-tailed task durations
    (the ``_trace_like`` duration model, per-job)."""

    def factory(rng: random.Random, i: int) -> Sequence[float]:
        del i
        mean = long_mean if rng.random() < long_fraction else short_mean
        return [max(0.05, _pareto(rng, mean)) for _ in range(tasks_per_job)]

    return factory


class ArrivalProcess:
    """Base open-loop arrival process: an unbounded (or finite), time-ordered
    job stream the streaming engine pulls on demand.

    Subclasses implement ``_iats(rng)`` — an iterator of inter-arrival
    times — and inherit ``jobs()``: a deterministic restartable iterator of
    ``Job``s (ids numbered from 0, strictly ordered submit times, shapes
    drawn from ``job_factory``).  ``mean_rate`` is the long-run arrival
    rate in jobs per simulated second; ``offered_load(W)`` converts it to
    the paper's demand/capacity ratio (Eq. 6)."""

    name = "arrivals"

    def __init__(
        self,
        job_factory: Optional[JobFactory] = None,
        seed: int = 0,
        num_jobs: Optional[int] = None,
    ) -> None:
        self.job_factory = job_factory or fixed_job_factory()
        self.seed = seed
        self.num_jobs = num_jobs  # None = unbounded

    # -- subclass hooks -------------------------------------------------
    def _iats(self, rng: random.Random) -> Iterator[float]:
        raise NotImplementedError

    @property
    def mean_rate(self) -> float:
        """Long-run arrival rate (jobs / simulated second)."""
        raise NotImplementedError

    # -- shared machinery -----------------------------------------------
    def mean_job_demand(self, samples: int = 256) -> float:
        """Mean resource-seconds per job, estimated from the job factory
        with a dedicated rng (deterministic; exact for fixed shapes)."""
        rng = random.Random(f"{self.seed}/demand")
        tot = 0.0
        for i in range(samples):
            tot += sum(self.job_factory(rng, i))
        return tot / samples

    def offered_load(self, num_workers: int) -> float:
        """Long-run demand / capacity (Eq. 6): rate x mean job
        resource-seconds / worker count.  > 1 means sustained overload."""
        return self.mean_rate * self.mean_job_demand() / num_workers

    def jobs(self) -> Iterator[Job]:
        """Restartable deterministic job stream: same seed => identical
        jobs, bit-for-bit.  Submit times are strictly increasing (ties
        nudged by the minimum float step) so job order is unambiguous."""
        rng_t = random.Random(f"{self.seed}/arrivals")
        rng_j = random.Random(f"{self.seed}/shapes")
        t = 0.0
        i = 0
        for iat in self._iats(rng_t):
            if self.num_jobs is not None and i >= self.num_jobs:
                return
            t_next = t + iat
            t = t_next if t_next > t else math.nextafter(t, math.inf)
            durs = list(self.job_factory(rng_j, i))
            yield Job(job_id=i, submit_time=t, durations=durs)
            i += 1


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals: iid Exp(1/rate) inter-arrival times."""

    name = "poisson"

    def __init__(self, rate: float, **kw) -> None:
        if rate <= 0:
            raise ValueError("arrival rate must be positive")
        super().__init__(**kw)
        self.rate = float(rate)

    @property
    def mean_rate(self) -> float:
        return self.rate

    def _iats(self, rng: random.Random) -> Iterator[float]:
        while True:
            yield rng.expovariate(self.rate)


class MMPPArrivals(ArrivalProcess):
    """Markov-modulated Poisson process: the arrival rate switches between
    regimes (e.g. calm/burst) with exponentially distributed dwell times —
    the standard bursty-traffic model (2-state MMPP by default).

    ``rates[k]`` is regime k's Poisson rate, ``dwell[k]`` its mean dwell
    time; the chain cycles ``0 -> 1 -> ... -> 0`` (for two states this IS
    the general alternating MMPP)."""

    name = "mmpp"

    def __init__(
        self,
        rates: Sequence[float] = (2.0, 20.0),
        dwell: Sequence[float] = (20.0, 5.0),
        **kw,
    ) -> None:
        if len(rates) != len(dwell) or not rates:
            raise ValueError("rates and dwell must be equal-length, non-empty")
        if min(rates) <= 0 or min(dwell) <= 0:
            raise ValueError("rates and dwell times must be positive")
        super().__init__(**kw)
        self.rates = tuple(float(r) for r in rates)
        self.dwell = tuple(float(d) for d in dwell)

    @property
    def mean_rate(self) -> float:
        # time-weighted by expected dwell per cycle
        tot = sum(self.dwell)
        return sum(r * d for r, d in zip(self.rates, self.dwell)) / tot

    def _iats(self, rng: random.Random) -> Iterator[float]:
        k = 0
        regime_left = rng.expovariate(1.0 / self.dwell[0])
        while True:
            iat = 0.0
            gap = rng.expovariate(self.rates[k])
            # cross regime boundaries: the elapsed dwell counts toward the
            # inter-arrival time, and the memoryless residual is rescaled
            # by the rate ratio (exact for the MMPP)
            while gap > regime_left:
                iat += regime_left
                gap = (gap - regime_left) * self.rates[k]
                k = (k + 1) % len(self.rates)
                gap /= self.rates[k]
                regime_left = rng.expovariate(1.0 / self.dwell[k])
            regime_left -= gap
            yield iat + gap


class DiurnalArrivals(ArrivalProcess):
    """Inhomogeneous Poisson with a sinusoidal diurnal load curve:
    ``rate(t) = base_rate * (1 + amplitude * sin(2 pi t / period))``,
    generated by Lewis-Shedler thinning against the peak rate (exact)."""

    name = "diurnal"

    def __init__(
        self,
        base_rate: float,
        amplitude: float = 0.5,
        period: float = 240.0,
        **kw,
    ) -> None:
        if base_rate <= 0 or period <= 0:
            raise ValueError("base_rate and period must be positive")
        if not (0.0 <= amplitude < 1.0):
            raise ValueError("amplitude must be in [0, 1)")
        super().__init__(**kw)
        self.base_rate = float(base_rate)
        self.amplitude = float(amplitude)
        self.period = float(period)

    @property
    def mean_rate(self) -> float:
        return self.base_rate  # the sinusoid integrates to zero per period

    def rate_at(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period)
        )

    def _iats(self, rng: random.Random) -> Iterator[float]:
        peak = self.base_rate * (1.0 + self.amplitude)
        t = 0.0
        last = 0.0
        while True:
            t += rng.expovariate(peak)
            if rng.random() * peak <= self.rate_at(t):
                yield t - last
                last = t


class PhasedArrivals(ArrivalProcess):
    """Piecewise-constant-rate Poisson phases: ``phases`` is a sequence of
    ``(duration_seconds, rate)`` segments, cycled (the last phase repeats
    forever when ``cycle=False``); they drive the overload -> recovery
    transient: e.g. ``[(60, feasible), (30, overload), (120, feasible)]``."""

    name = "phased"

    def __init__(
        self,
        phases: Sequence[tuple[float, float]],
        cycle: bool = False,
        **kw,
    ) -> None:
        if not phases or min(d for d, _ in phases) <= 0 or min(
            r for _, r in phases
        ) <= 0:
            raise ValueError("phases need positive durations and rates")
        super().__init__(**kw)
        self.phases = tuple((float(d), float(r)) for d, r in phases)
        self.cycle = bool(cycle)

    @property
    def mean_rate(self) -> float:
        if self.cycle:
            tot = sum(d for d, _ in self.phases)
            return sum(d * r for d, r in self.phases) / tot
        return self.phases[-1][1]  # long-run: the final (repeating) phase

    def _iats(self, rng: random.Random) -> Iterator[float]:
        t = 0.0
        last = 0.0
        k = 0
        phase_end = self.phases[0][0]
        while True:
            t += rng.expovariate(self.phases[k][1])
            while t > phase_end:
                # thinning-free regime switch: re-draw from the boundary
                # (slightly conservative at boundaries; phases >> 1/rate)
                t = phase_end + rng.expovariate(self.phases[k][1])
                if k + 1 < len(self.phases):
                    k += 1
                elif self.cycle:
                    k = 0
                phase_end += self.phases[k][0]
            yield t - last
            last = t


class ReplayArrivals(ArrivalProcess):
    """Replay a finite ``Workload`` as an arrival process (submit order) —
    the streamed-vs-fixed parity pin's bridge: streaming a replay through
    the ring-buffer window must reproduce the fixed-trace run."""

    name = "replay"

    def __init__(self, workload: Workload) -> None:
        super().__init__(job_factory=fixed_job_factory(), seed=0,
                         num_jobs=workload.num_jobs)
        self.workload = workload

    @property
    def mean_rate(self) -> float:
        jobs = self.workload.sorted_jobs()
        span = jobs[-1].submit_time - jobs[0].submit_time if len(jobs) > 1 else 0.0
        return len(jobs) / span if span > 0 else float("inf")

    def mean_job_demand(self, samples: int = 256) -> float:
        del samples
        return self.workload.makespan_demand / max(1, self.workload.num_jobs)

    def jobs(self) -> Iterator[Job]:
        for i, j in enumerate(self.workload.sorted_jobs()):
            yield Job(
                job_id=i,
                submit_time=j.submit_time,
                durations=list(j.durations),
                estimated_duration=j.estimated_duration,
            )
