"""Dense-tensor datacenter state for the simx backend (port of
``repro/simx/state.py``).

  * ``TaskArrays``  — the workload exported to flat per-task/per-job
                      tensors (tasks sorted by job submission time, so task
                      index order == FIFO arrival order).
  * ``SimxConfig``  — static simulation parameters, with the reference's
                      auto rules for the sparrow/eagle queue sizes.
  * ``CoreState``   — the round-carry base every rule shares: simulated
                      time, per-task lifecycle, per-worker run state and
                      the metric counters.  ``QueueState`` extends it with
                      the sparrow/eagle reservation-queue fields.
  * ``MeghaState`` / ``SparrowState`` / ``EagleState`` / ``PigeonState`` /
    ``OracleState`` — ``CoreState`` plus each rule's own fields.
  * ``fifo_rows``   — the per-row FIFOs of task ids that megha, pigeon and
                      eagle build their layouts from (fixed traces and the
                      streaming window alike).

A sweep grid runs B points at once (``repro_torch.simx.sweep``): its
state carries a leading axis of B points on every field (the specs below
name one point's shapes), and its ``TaskArrays`` carry one ``submit`` /
``job_submit`` row per point (``float32[B, T]`` / ``[B, J]``) while the
structural arrays stay shared.  The sharded steady state's lanes
(``repro_torch.simx.shard``) each stream their own window, so there every
``TaskArrays`` field carries the leading axis (``int32[L, T]`` jobs,
``float32[L, T]`` durations, ...).

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
import math
from dataclasses import dataclass
from typing import NamedTuple

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
        return self.job.shape[-1]

    @property
    def num_jobs(self) -> int:
        return self.job_ideal.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.job.device

    @property
    def batch(self) -> int | None:
        """Points of a grid's per-point arrival times (or lanes of
        lane-stacked windows); None when shared."""
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
    """Static simulation parameters (the reference's, without its
    ``match_window`` override, which no caller sets, and its ``seed``: the
    port's rules take their draws as an argument)."""

    num_workers: int
    num_gms: int = 8
    num_lms: int = 8
    dt: float = 0.05                 # round length (seconds of simulated time)
    heartbeat_interval: float = 5.0  # §4.1
    hop: float = 0.0005              # §4.1 constant network delay
    probe_ratio: int = 2             # sparrow/eagle's d
    # eagle (§2.2.3): estimate-based short/long split + reserved short slice
    long_threshold: float = 10.0     # core.base.LONG_JOB_THRESHOLD
    short_partition_fraction: float = 0.10
    # pigeon (§2.2.4): fixed worker groups + weighted fair queuing
    num_distributors: int = 5
    group_size: int = 40
    reserved_per_group: int = 2      # high-priority-only workers per group
    wfq_weight: int = 4              # one low-priority task per `weight` high
    # sparrow/eagle capped per-worker reservation queues: queue slots per
    # worker and probe-insertion window width; 0 = auto (queue_cap and
    # insert_window)
    reserve_cap: int = 0
    probe_window: int = 0

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

    @property
    def short_reserved(self) -> int:
        """Workers [0, short_reserved) only ever run short tasks (Eagle's
        short partition)."""
        return max(1, int(self.num_workers * self.short_partition_fraction))

    def queue_cap(self, num_edges: int) -> int:
        """R — reservation-queue slots per worker.  Auto (``reserve_cap ==
        0``): twice the average number of probes a worker receives over
        the whole trace, floored at 8 and capped at 64; a full queue drops
        the probe into ``res_overflow`` and orphan rescue keeps the job
        schedulable."""
        if self.reserve_cap:
            return int(self.reserve_cap)
        avg = math.ceil(num_edges / max(self.num_workers, 1))
        return int(min(max(8, 2 * avg), 64))

    def insert_window(self, num_edges: int, kmax: int) -> int:
        """C — probe edges examined per round by the windowed insertion.
        Auto (``probe_window == 0``): at least four max-size jobs' worth of
        probes plus 1/32nd of the edge list, so a whole-trace burst drains
        in about 32 rounds; a saturated round counts in ``probe_lag``."""
        if num_edges <= 0:
            return 1
        if self.probe_window:
            return int(min(self.probe_window, num_edges))
        return int(min(num_edges, max(256, 4 * kmax, math.ceil(num_edges / 32))))

    def partition_gms(self, device: str | torch.device) -> torch.Tensor:
        """int32[W] — which GM owns each worker's partition."""
        w = np.arange(self.num_workers)
        return torch.from_numpy(
            ((w % self.workers_per_lm) // self.partition_size).astype(np.int32)
        ).to(device)


def probe_edge_layout(
    cfg: SimxConfig, tasks: TaskArrays, short_only: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The probe *edge list*, in numpy and structural only: every (job,
    probe) pair the trace will ever send, sorted by job id (== submit
    order, so arrival readiness is a prefix of the list).

    Job j contributes ``k_j = min(probe_ratio * n_tasks_j, W)`` edges
    (``short_only`` zeroes the long jobs, for eagle).  Returns
    ``(edge_job int32[P], edge_rank int32[P], edge_end int32[J], kmax)``:
    ``edge_rank`` is the probe's column in the job's target table and
    ``edge_end[j]`` the exclusive end of j's edges."""
    n = tasks.job_ntasks.cpu().numpy().astype(np.int64)
    k = np.minimum(cfg.probe_ratio * n, cfg.num_workers)
    if short_only:
        k = np.where(tasks.job_est.cpu().numpy() < cfg.long_threshold, k, 0)
    edge_job = np.repeat(np.arange(n.size, dtype=np.int32), k)
    edge_end = np.cumsum(k)
    starts = (edge_end - k)[edge_job]
    edge_rank = (np.arange(edge_job.size) - starts).astype(np.int32)
    kmax = int(k.max()) if k.size else 0
    return edge_job, edge_rank, edge_end.astype(np.int32), kmax


class FifoRows(NamedTuple):
    """A task set's FIFO rows on the host (``fifo_rows``)."""

    rows: np.ndarray  # int32[N, width]: each row's task ids, then the sentinel
    lens: np.ndarray  # int32[N]: the rows' real lengths
    pos: np.ndarray   # int32[T]: each task's position in its row (0 in none)


def fifo_rows(task_row: np.ndarray, n_rows: int, width: int, sentinel: int) -> FifoRows:
    """The FIFO rows every queueing rule's layout is built from, for a
    fixed trace and for the stream's window alike: row r lists the tasks
    with ``task_row == r`` in ascending task id (== submit order), padded
    with ``sentinel`` to ``width``; ``task_row`` -1 puts a task in no row.
    One stable sort by row, not a loop over rows, jobs or groups."""
    tids = np.flatnonzero(task_row >= 0).astype(np.int32)
    rows_of = task_row[tids]
    ordered = tids[np.argsort(rows_of, kind="stable")]  # row by row, FIFO within
    lens = np.bincount(rows_of, minlength=n_rows).astype(np.int32)
    rows = np.full((n_rows, width), sentinel, np.int32)
    rows[np.arange(width) < lens[:, None]] = ordered    # row-major: the same order
    pos = np.zeros(task_row.size, np.int32)
    pos[ordered] = np.arange(ordered.size, dtype=np.int32) - np.repeat(
        np.cumsum(lens) - lens, lens)
    return FifoRows(rows, lens, pos)


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
class QueueState(CoreState):
    """``CoreState`` plus the capped per-worker reservation-queue fields
    shared by the sparrow and eagle rules."""

    resq: torch.Tensor = spec("int32[W, R]")   # reservation queues (J = empty),
                              # compacted each round, ascending job id
    probe_head: torch.Tensor = spec("int32[]")  # inserted edge-list prefix
    res_overflow: torch.Tensor = spec("int32[]")  # probes dropped on full queues
    probe_lag: torch.Tensor = spec("int32[]")  # rounds the insertion window
                              # saturated (arrival burst outran it)


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
class SparrowState(QueueState):
    """Round carry of the sparrow rule: the capped queues ``resq``
    (``int32[W, R]`` of job ids, J = empty, O(W) whatever the trace's
    length) and the insertion head into the static probe edge list."""


@dataclass(frozen=True)
class EagleState(QueueState):
    """Round carry of the eagle rule: the sparrow queue fields (``resq``
    holds the short-job reservations, after SSS re-routing) plus the
    central long-FIFO head."""

    long_head: torch.Tensor = spec("int32[]")  # launched central-FIFO prefix


def _queue_fields(cfg: SimxConfig, tasks: TaskArrays, short_only: bool, batch) -> dict:
    """The ``QueueState`` fields of a fresh DC: empty queues of
    ``queue_cap`` slots, sized off the trace's edge count."""
    *_, edge_end, _kmax = probe_edge_layout(cfg, tasks, short_only=short_only)
    cap = cfg.queue_cap(int(edge_end[-1]) if tasks.num_jobs else 0)
    b = _lead(batch)
    i32 = dict(dtype=torch.int32, device=tasks.device)
    return dict(
        resq=torch.full(b + (cfg.num_workers, cap), tasks.num_jobs, **i32),
        probe_head=torch.zeros(b, **i32),
        res_overflow=torch.zeros(b, **i32),
        probe_lag=torch.zeros(b, **i32),
        **_common_fields(cfg, tasks.num_tasks, tasks.device, batch),
    )


def init_sparrow_state(
    cfg: SimxConfig, tasks: TaskArrays, batch: int | None = None
) -> SparrowState:
    return SparrowState(**_queue_fields(cfg, tasks, False, batch))


def init_eagle_state(
    cfg: SimxConfig, tasks: TaskArrays, batch: int | None = None
) -> EagleState:
    return EagleState(
        long_head=torch.zeros(_lead(batch), dtype=torch.int32, device=tasks.device),
        **_queue_fields(cfg, tasks, True, batch),
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
