"""The general traffic generator: a Fig. 2 grid's inputs, made from a seed.

A traffic mix is a data file under ``portbench/traffic/`` (the generator
that makes its trace, loads, scheduler seeds a load, and the generator's own
parameters).  This module turns one mix and one configuration into the
inputs both sides get: the trace of every load, the rule's random draws for
every scheduler seed, and the round budget.  It imports nothing of the
program, so the reference can be handed the very same tensors.

Two kinds of file are found by name, so that a new trace shape or a new
rule needs files only:

* ``portbench/generators/<generator>.py`` (the mix's ``generator``) has
  ``trace(cfg, traffic, seed)``: a dict of numpy arrays ``job int32[T]``,
  ``duration float32[T]`` and ``job_ntasks int32[J]`` (tasks in job order)
  and ``job_submit float32[L, J]``, one row per load of ``traffic["loads"]``;
* ``portbench/draws/<scheduler>.py`` (the configuration's ``scheduler``)
  has ``make(cfg, trace, seed, device)``: the rule's random draws for one
  scheduler seed, a dict of tensors by the rule's names (``{}`` for a rule
  that draws nothing), stacked here over the seeds.

The round budget is the plan's rule (``fig2_plan``): arrival span + slack x
the perfectly packed drain + the longest task + one heartbeat + 1 s, over
``dt``, at the slowest load.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

#: where the generator and draws files lie
HERE = Path(__file__).resolve().parent


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


def round_budget(cfg: dict, traffic: dict, max_submit: float, durations: np.ndarray) -> int:
    """The plan's round budget for the slowest point (``max_submit`` its
    last arrival)."""
    span = (max_submit
            + traffic["slack"] * float(durations.sum()) / cfg["num_workers"]
            + float(durations.max())
            + cfg["heartbeat_interval"]
            + 1.0)
    return int(math.ceil(span / cfg["dt"]))


def load_part(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``; an error that names the
    path where it is missing."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cfg: dict, traffic: dict, seed: int, device) -> GridInputs:
    """One cell's inputs from ``seed``: the mix's generator makes the trace
    from ``seed``, and the rule's draws of scheduler seed ``i`` come from
    ``seed + i``."""
    scheduler = cfg["scheduler"]
    make = load_part("draws", scheduler).make
    trace = load_part("generators", traffic["generator"]).trace(cfg, traffic, seed)
    loads = tuple(float(x) for x in traffic["loads"])
    job_submit = trace["job_submit"]
    if job_submit.shape[0] != len(loads):
        raise ValueError(f"{traffic['generator']} made {job_submit.shape[0]} rows of "
                         f"arrivals for {len(loads)} loads")
    durations = trace["duration"]
    seeds = tuple(seed + i for i in range(int(traffic["scheduler_seeds"])))
    per_seed = [make(cfg, trace, s, device) for s in seeds]
    draws = {k: torch.stack([d[k] for d in per_seed]) for k in per_seed[0]}
    jobs_t = torch.from_numpy(trace["job"]).to(device)
    job_submit_t = torch.from_numpy(job_submit).to(device)
    return GridInputs(
        scheduler=scheduler,
        loads=loads,
        seeds=seeds,
        job=jobs_t,
        duration=torch.from_numpy(durations).to(device),
        job_ntasks=torch.from_numpy(trace["job_ntasks"]).to(device),
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
