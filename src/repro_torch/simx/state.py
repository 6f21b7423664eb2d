"""Dense-tensor datacenter state for the simx backend (port of
``repro/simx/state.py``, the megha, pigeon and oracle parts).

  * ``TaskArrays``  — the workload exported to flat per-task/per-job
                      tensors (tasks sorted by job submission time, so task
                      index order == FIFO arrival order).
  * ``SimxConfig``  — static simulation parameters.
  * ``CoreState``   — the round-carry base every rule shares: simulated
                      time, per-task lifecycle, per-worker run state and
                      the metric counters.
  * ``MeghaState`` / ``PigeonState`` / ``OracleState`` — ``CoreState``
                      plus each rule's own fields.

A sweep grid runs B points at once (``repro_torch.simx.sweep``): its
state carries a leading axis of B points on every field (the specs below
name one point's shapes), and its ``TaskArrays`` carry one ``submit`` /
``job_submit`` row per point (``float32[B, T]`` / ``[B, J]``) while the
structural arrays stay shared.

States are frozen dataclasses of tensors; a round builds a new state with
``replace`` and never writes into the old one's tensors.  Counters and
ranks stay int32 and times float32, as in the reference, so the two
packages' states compare bitwise.

Task lifecycle is encoded by ONE float tensor: ``task_finish = start +
duration`` is recorded at launch, so

  pending  : ``task_finish == inf`` (queued once ``submit <= t``)
  running  : launched, ``task_finish > t``
  done     : ``task_finish <= t``
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.workload.traces import Workload


def spec(text: str, **kw) -> dataclasses.Field:
    """Declare a field's machine-readable shape/dtype contract: the
    reference's ``spec`` (``dataclasses.field`` with the contract string in
    the metadata), kept so a spec checker can read the port's states too."""
    md = dict(kw.pop("metadata", {}))
    md["spec"] = text
    return dataclasses.field(metadata=md, **kw)


@dataclass(frozen=True)
class TaskArrays:
    """The workload as flat tensors (T tasks over J jobs, no padding)."""

    job: torch.Tensor = spec("int32[T]")          # job position in submit order
    duration: torch.Tensor = spec("float32[T]")
    submit: torch.Tensor = spec("float32[T]")     # the job's submission time
                                                  # ([B, T] in a grid)
    job_submit: torch.Tensor = spec("float32[J]")  # ([B, J] in a grid)
    job_ideal: torch.Tensor = spec("float32[J]")  # IdealJCT = max task duration
    job_ntasks: torch.Tensor = spec("int32[J]")
    job_est: torch.Tensor = spec("float32[J]")    # estimated runtime

    @property
    def num_tasks(self) -> int:
        return self.job.shape[0]

    @property
    def num_jobs(self) -> int:
        return self.job_ideal.shape[0]

    @property
    def device(self) -> torch.device:
        return self.job.device

    @property
    def batch(self) -> int | None:
        """Points of a grid's per-point arrival times; None when shared."""
        return self.submit.shape[0] if self.submit.dim() == 2 else None

    def replace(self, **kw) -> "TaskArrays":
        return dataclasses.replace(self, **kw)


def export_workload(wl: Workload, device: str | torch.device) -> TaskArrays:
    """Flatten a ``Workload`` into ``TaskArrays`` on ``device`` (jobs in
    submit order)."""
    jobs = wl.sorted_jobs()
    n_tasks = sum(j.num_tasks for j in jobs)
    task_job = np.empty(n_tasks, np.int32)
    task_dur = np.empty(n_tasks, np.float32)
    task_sub = np.empty(n_tasks, np.float32)
    job_sub = np.empty(len(jobs), np.float32)
    job_ideal = np.empty(len(jobs), np.float32)
    job_nt = np.empty(len(jobs), np.int32)
    job_est = np.empty(len(jobs), np.float32)
    k = 0
    for p, j in enumerate(jobs):
        c = j.num_tasks
        task_job[k : k + c] = p
        task_dur[k : k + c] = np.asarray(j.durations, np.float32)
        task_sub[k : k + c] = j.submit_time
        job_sub[p] = j.submit_time
        job_ideal[p] = j.ideal_jct
        job_nt[p] = c
        job_est[p] = j.estimated_duration
        k += c
    return TaskArrays(
        job=torch.from_numpy(task_job).to(device),
        duration=torch.from_numpy(task_dur).to(device),
        submit=torch.from_numpy(task_sub).to(device),
        job_submit=torch.from_numpy(job_sub).to(device),
        job_ideal=torch.from_numpy(job_ideal).to(device),
        job_ntasks=torch.from_numpy(job_nt).to(device),
        job_est=torch.from_numpy(job_est).to(device),
    )


@dataclass(frozen=True)
class SimxConfig:
    """Static simulation parameters of the megha, pigeon and oracle rules
    (the reference's fields for sparrow and eagle come with their slice;
    its ``match_window`` override, which no caller sets, is not carried)."""

    num_workers: int
    num_gms: int = 8
    num_lms: int = 8
    dt: float = 0.05                 # round length (seconds of simulated time)
    heartbeat_interval: float = 5.0  # §4.1
    hop: float = 0.0005              # §4.1 constant network delay
    long_threshold: float = 10.0     # core.base.LONG_JOB_THRESHOLD
    # pigeon (§2.2.4): fixed worker groups + weighted fair queuing
    num_distributors: int = 5
    group_size: int = 40
    reserved_per_group: int = 2      # high-priority-only workers per group
    wfq_weight: int = 4              # one low-priority task per `weight` high

    def validate_megha_grid(self) -> None:
        """Megha needs the GM x LM partition grid to divide evenly."""
        if self.num_workers % (self.num_gms * self.num_lms):
            raise ValueError("num_workers must divide into GM x LM partitions")

    @property
    def workers_per_lm(self) -> int:
        return self.num_workers // self.num_lms

    @property
    def partition_size(self) -> int:
        return self.workers_per_lm // self.num_gms

    @property
    def heartbeat_rounds(self) -> int:
        return max(1, int(round(self.heartbeat_interval / self.dt)))

    @property
    def num_groups(self) -> int:
        """Pigeon's fixed worker groups; the last group absorbs the
        remainder."""
        return max(1, self.num_workers // self.group_size)

    def partition_gms(self, device: str | torch.device) -> torch.Tensor:
        """int32[W] — which GM owns each worker's partition."""
        w = np.arange(self.num_workers)
        return torch.from_numpy(
            ((w % self.workers_per_lm) // self.partition_size).astype(np.int32)
        ).to(device)


def _lead(batch: int | None) -> tuple:
    """The leading shape of a state's fields: () unbatched, (B,) else."""
    return () if batch is None else (batch,)


def _common_fields(cfg: SimxConfig, num_tasks: int, device, batch: int | None) -> dict:
    w, b = cfg.num_workers, _lead(batch)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        t=torch.zeros(b, **f32),
        rnd=torch.zeros(b, **i32),
        task_finish=torch.full(b + (num_tasks,), float("inf"), **f32),
        # a worker is free iff worker_finish <= t; -inf = never ran anything
        worker_finish=torch.full(b + (w,), float("-inf"), **f32),
        # last task launched here (T = none)
        worker_task=torch.full(b + (w,), num_tasks, **i32),
        inconsistencies=torch.zeros(b, **i32),
        repartitions=torch.zeros(b, **i32),
        messages=torch.zeros(b, **i32),
        probes=torch.zeros(b, **i32),
        lost=torch.zeros(b, **i32),  # in-flight tasks lost to worker crashes
    )


@dataclass(frozen=True)
class CoreState:
    """The round-carry fields every rule shares — what the round-stage
    runtime (``repro_torch.simx.runtime``) reads and advances."""

    t: torch.Tensor = spec("float32[]")     # simulated time at round start
    rnd: torch.Tensor = spec("int32[]")
    task_finish: torch.Tensor = spec("float32[T]")   # inf until launched
                                                     # (= start + duration)
    worker_finish: torch.Tensor = spec("float32[W]")  # free iff <= t
    worker_task: torch.Tensor = spec("int32[W]")  # last task launched (T = none)
    inconsistencies: torch.Tensor = spec("int32[]")
    repartitions: torch.Tensor = spec("int32[]")
    messages: torch.Tensor = spec("int32[]")
    probes: torch.Tensor = spec("int32[]")
    lost: torch.Tensor = spec("int32[]")    # tasks lost to worker crashes

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeghaState(CoreState):
    """Round carry of the megha rule."""

    head: torch.Tensor = spec("int32[G]")  # launched prefix of each GM's FIFO
    worker_gm: torch.Tensor = spec("int32[W]")  # GM that scheduled the last task
    worker_borrowed: torch.Tensor = spec("bool[W]")   # last task was a borrow
    view: torch.Tensor = spec("bool[G, W]")  # per-GM stale availability view


def init_megha_state(
    cfg: SimxConfig, num_tasks: int, device, batch: int | None = None
) -> MeghaState:
    w, g, b = cfg.num_workers, cfg.num_gms, _lead(batch)
    return MeghaState(
        head=torch.zeros(b + (g,), dtype=torch.int32, device=device),
        worker_gm=torch.zeros(b + (w,), dtype=torch.int32, device=device),
        worker_borrowed=torch.zeros(b + (w,), dtype=torch.bool, device=device),
        view=torch.ones(b + (g, w), dtype=torch.bool, device=device),
        **_common_fields(cfg, num_tasks, device, batch),
    )


@dataclass(frozen=True)
class PigeonState(CoreState):
    """Round carry of the pigeon rule."""

    high_head: torch.Tensor = spec("int32[NG]")  # launched prefix of each
    low_head: torch.Tensor = spec("int32[NG]")   # group's high/low FIFO
    since_low: torch.Tensor = spec("int32[NG]")  # WFQ: highs since the last low


def init_pigeon_state(
    cfg: SimxConfig, num_tasks: int, device, batch: int | None = None
) -> PigeonState:
    shape = _lead(batch) + (cfg.num_groups,)
    return PigeonState(
        high_head=torch.zeros(shape, dtype=torch.int32, device=device),
        low_head=torch.zeros(shape, dtype=torch.int32, device=device),
        since_low=torch.zeros(shape, dtype=torch.int32, device=device),
        **_common_fields(cfg, num_tasks, device, batch),
    )


@dataclass(frozen=True)
class OracleState(CoreState):
    """Round carry of the omniscient-oracle rule: one global FIFO head."""

    head: torch.Tensor = spec("int32[]")  # launched global-FIFO prefix


def init_oracle_state(
    cfg: SimxConfig, num_tasks: int, device, batch: int | None = None
) -> OracleState:
    return OracleState(
        head=torch.zeros(_lead(batch), dtype=torch.int32, device=device),
        **_common_fields(cfg, num_tasks, device, batch),
    )
