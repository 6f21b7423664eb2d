"""The general traffic generator: a Fig. 2 grid's inputs, made from a seed.

A traffic mix is a data file under ``portbench/traffic/`` (loads, scheduler
seeds a load, jobs a point, tasks a job, task length, arrival law, the round
budget's slack).  This module turns one mix and one configuration into the
inputs both sides get: the trace of every load, the rules' random draws for
every scheduler seed, and the round budget.  It imports nothing of the
program, so the reference can be handed the very same tensors.

The trace is the paper's synthetic one (Megha, arXiv:2308.10178, Table 1
and Eq. 6): jobs of ``tasks_per_job`` tasks of ``task_duration`` seconds,
Poisson arrivals whose mean gap is

    iat = tasks_per_job * task_duration / (load * num_workers),

one set of unit gaps drawn from the seed with ``random.Random(seed)`` and
scaled by each load's ``iat``, as ``workload/synth.py::synthetic_trace`` of
the repository does, with one difference: the arrival law
``poisson_fixed_span`` conditions the Poisson process on its span.  The unit
gaps are rescaled so that the last job arrives at exactly ``(num_jobs - 1) *
iat``.  The points of a Poisson process given their count and span are
uniform over the span, so the arrivals stay Poisson, while every seed gets
the same span, the same round budget and so the same number of rounds.

The round budget is the plan's rule (``fig2_plan``): arrival span + slack x
the perfectly packed drain + the longest task + one heartbeat + 1 s, over
``dt``, at the slowest load.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ARRIVALS = ("poisson_fixed_span",)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class GridInputs:
    """Everything one cell's grid is run from, on one device.

    ``submit[L, T]`` / ``job_submit[L, J]`` are the loads' arrival times,
    ``job`` / ``duration`` / ``job_ntasks`` the shared trace structure
    (tasks in job order), ``draws`` the rule's random draws by name, each
    with a leading axis of the S scheduler seeds, and ``num_rounds`` the
    round budget.  Point ``b`` of the grid is load ``b // S``, seed
    ``b % S``."""

    scheduler: str
    loads: tuple[float, ...]
    seeds: tuple[int, ...]
    job: torch.Tensor          # int32[T]
    duration: torch.Tensor     # float32[T]
    job_ntasks: torch.Tensor   # int32[J]
    submit: torch.Tensor       # float32[L, T]
    job_submit: torch.Tensor   # float32[L, J]
    draws: dict
    num_rounds: int

    @property
    def num_points(self) -> int:
        return len(self.loads) * len(self.seeds)

    @property
    def num_tasks(self) -> int:
        return int(self.job.shape[0])

    @property
    def num_jobs(self) -> int:
        return int(self.job_ntasks.shape[0])

    def point(self, b: int) -> tuple[int, int]:
        """(load index, seed index) of point ``b``."""
        return divmod(b, len(self.seeds))


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


def round_budget(cfg: dict, traffic: dict, max_submit: float, durations: np.ndarray) -> int:
    """The plan's round budget for the slowest point (``max_submit`` its
    last arrival)."""
    span = (max_submit
            + traffic["slack"] * float(durations.sum()) / cfg["num_workers"]
            + float(durations.max())
            + cfg["heartbeat_interval"]
            + 1.0)
    return int(math.ceil(span / cfg["dt"]))


def megha_orders(cfg: dict, seed: int, device) -> torch.Tensor:
    """int32[G, W]: each GM's priority order, its own partitions' workers
    shuffled first, then every other worker shuffled (Megha §3.3).  A
    worker's partition belongs to GM ``(w % (W / L)) // (W / L / G)``."""
    W, G, L = cfg["num_workers"], cfg["num_gms"], cfg["num_lms"]
    if W % (G * L):
        raise ValueError(f"{W} workers do not divide into {G} x {L} partitions")
    per_lm = W // L
    owner = (torch.arange(W, device=device) % per_lm) // (per_lm // G)
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.rand((G, W), generator=gen, dtype=torch.float64, device=device)
    keys = keys + 2.0 * (owner[None, :] != torch.arange(G, device=device)[:, None])
    return torch.argsort(keys, dim=1, stable=True).to(torch.int32)


def sparrow_targets(cfg: dict, job_ntasks: np.ndarray, seed: int, device) -> torch.Tensor:
    """int32[J, kmax]: each job's probe targets, its first ``min(d n, W)``
    entries a uniform ordered sample of distinct workers (batch sampling,
    Sparrow §3.2): the workers of the ``kmax`` largest of W uniform scores,
    in descending order of score."""
    W = cfg["num_workers"]
    kmax = int(min(cfg["probe_ratio"] * int(job_ntasks.max()), W))
    gen = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand((len(job_ntasks), W), generator=gen, dtype=torch.float64,
                        device=device)
    return torch.topk(scores, kmax, dim=1).indices.to(torch.int32)


#: rule -> (draw name, maker(cfg, job_ntasks, seed, device))
DRAWS = {
    "megha": ("orders", lambda cfg, nt, seed, dev: megha_orders(cfg, seed, dev)),
    "sparrow": ("targets", sparrow_targets),
}


def build(cfg: dict, traffic: dict, seed: int, device) -> GridInputs:
    """One cell's inputs from ``seed``: the trace from ``random.Random(seed)``
    and scheduler seed ``i`` drawn from ``seed + i``."""
    scheduler = cfg["scheduler"]
    if scheduler not in DRAWS:
        raise ValueError(f"no draws are defined for scheduler {scheduler!r}")
    loads = tuple(float(x) for x in traffic["loads"])
    J, n = int(traffic["num_jobs"]), int(traffic["tasks_per_job"])
    dur = float(traffic["task_duration"])
    W = cfg["num_workers"]
    unit = unit_arrivals(seed, J, traffic["arrivals"])
    job_submit = np.stack([
        (unit * mean_gap(load, n, dur, W)).astype(np.float32) for load in loads])
    job = np.repeat(np.arange(J, dtype=np.int32), n)
    durations = np.full(J * n, dur, np.float32)
    ntasks = np.full(J, n, np.int32)
    seeds = tuple(seed + i for i in range(int(traffic["scheduler_seeds"])))
    name, maker = DRAWS[scheduler]
    draws = {name: torch.stack([maker(cfg, ntasks, s, device) for s in seeds])}
    jobs_t = torch.from_numpy(job).to(device)
    job_submit_t = torch.from_numpy(job_submit).to(device)
    return GridInputs(
        scheduler=scheduler,
        loads=loads,
        seeds=seeds,
        job=jobs_t,
        duration=torch.from_numpy(durations).to(device),
        job_ntasks=torch.from_numpy(ntasks).to(device),
        submit=job_submit_t[:, jobs_t.to(torch.int64)],
        job_submit=job_submit_t,
        draws=draws,
        num_rounds=round_budget(cfg, traffic, float(job_submit.max()), durations),
    )


def sample_points(seed: int, inputs: GridInputs, k: int) -> list[int]:
    """The ``k`` points of a grid that the reference checks, drawn from the
    seed: always one point of the highest load (the longest delays, and for
    megha the most borrowing), the rest uniform over the other points."""
    rng = random.Random(f"sample-{seed}")
    S, B = len(inputs.seeds), inputs.num_points
    top = int(np.argmax(inputs.loads)) * S + rng.randrange(S)
    rest = [b for b in range(B) if b != top]
    return sorted([top] + rng.sample(rest, min(k, B) - 1))
