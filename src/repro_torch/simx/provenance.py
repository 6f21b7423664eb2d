"""Delay provenance: per-task lifecycle arrays and the delay decomposition
(port of ``repro/simx/provenance.py``).

An optional stage of the round runtime (``runtime.compose_step(...,
provenance=True)``), decided when the step is built:

  * ``Provenance`` — nine ``int32`` lifecycle arrays carried beside the
    scheduler state: the rounds at which each task became eligible, was
    first attempted by its scheduler, was (first/last) launched and
    finished, its fault re-pends and stale-state retries, and the
    placement identity (the scheduling authority and the worker of its
    last launch).  A batched run carries ``[B, T]`` arrays, one row per
    grid point; a single run ``[T]``.  Without the flag nothing of it is
    built, so the run is bitwise the provenance-free one.
  * Rule extras — a dispatch stage built with ``provenance=True`` returns
    a ``"provenance"`` dict: ``attempt`` bool[B, T] (tasks the scheduler
    considered this round), ``stale`` int32[B, T] (stale-state retry
    increments: megha's invalid proposals) and ``authority`` int32[B, W]
    or [W] (the entity that placed each worker's current task).  The
    runtime derives the launch, finish and re-pend transitions itself.
  * ``decompose_delays`` — each finished job's Eq. 2 delay split into
    eligible-wait, placement-wait, inconsistency-retry and fault-rework,
    summing to ``runtime.job_delays_from_state``'s delay.

The reference's ``.at[idx].set(..., mode="drop")`` scatters write a pad
slot (index T or J) that is cut off.  Where several workers name one task
(a crashed worker keeps the id of the task it lost, and that task can
relaunch elsewhere), XLA on the CPU applies the scatter in order and the
highest worker wins; the port finds that worker with a max-scatter of
worker indices, which does not depend on the order the card applies it
in.

Time convention, as in the reference: round ``r`` starts at ``r * dt``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.simx import runtime as rt
from repro_torch.simx.state import TaskArrays, spec

_I32, _I64 = torch.int32, torch.int64

#: sentinel for "round not reached yet" / "never placed"
UNSET = -1

#: the four decomposition components, in reporting order
COMPONENTS = (
    "eligible_wait",
    "placement_wait",
    "inconsistency_retry",
    "fault_rework",
)


@dataclass(frozen=True)
class Provenance:
    """Per-task lifecycle arrays (all ``int32[T]``, or ``[B, T]`` for a
    batch; rounds are ``UNSET`` until the event happens, placements
    ``UNSET`` until launched)."""

    first_eligible_round: torch.Tensor = spec("int32[T]")  # submit crossed clock
    first_attempt_round: torch.Tensor = spec("int32[T]")   # first sched attempt
    first_launch_round: torch.Tensor = spec("int32[T]")    # pre-fault-rework
    launch_round: torch.Tensor = spec("int32[T]")  # latest (== first w/o faults)
    finish_round: torch.Tensor = spec("int32[T]")  # finish time passed the clock
    requeue_count: torch.Tensor = spec("int32[T]")  # fault re-pends (crash loss)
    stale_retry_count: torch.Tensor = spec("int32[T]")  # stale-state retries
    placed_gm: torch.Tensor = spec("int32[T]")      # authority of last launch
    placed_worker: torch.Tensor = spec("int32[T]")  # worker of last launch

    def replace(self, **kw) -> "Provenance":
        return dataclasses.replace(self, **kw)


def init_provenance(num_tasks: int, device=None, batch: int | None = None) -> Provenance:
    """A fresh lifecycle carry for ``num_tasks`` tasks (``batch`` points)."""
    shape = (num_tasks,) if batch is None else (batch, num_tasks)
    unset = torch.full(shape, UNSET, dtype=_I32, device=device)
    zero = torch.zeros(shape, dtype=_I32, device=device)
    return Provenance(
        first_eligible_round=unset,
        first_attempt_round=unset,
        first_launch_round=unset,
        launch_round=unset,
        finish_round=unset,
        requeue_count=zero,
        stale_retry_count=zero,
        placed_gm=unset,
        placed_worker=unset,
    )


def advance_provenance(
    prov: Provenance,
    old_state,
    new_state,
    task_finish0: torch.Tensor,
    tasks: TaskArrays,
    extras: dict,
) -> Provenance:
    """One round's lifecycle transitions of a batched carry, derived from
    the state the dispatch stage computed (``compose_step`` calls this
    after folding the updates).

    ``task_finish0`` is the post-fault, pre-dispatch finish array, so a
    launch is pending-at-dispatch -> launched-after, and a fault re-pend
    is launched-before-faults -> pending-at-dispatch.  Without a fault
    stage ``task_finish0`` is the old state's own tensor and nothing can
    re-pend, so that count is left as it is (the reference adds zeros)."""
    T = tasks.num_tasks
    rnd = rt.lift(old_state.rnd, prov.launch_round)
    t = rt.lift(old_state.t, task_finish0)
    launched = torch.isinf(task_finish0) & ~torch.isinf(new_state.task_finish)
    requeue_count = prov.requeue_count
    if task_finish0 is not old_state.task_finish:
        requeued = ~torch.isinf(old_state.task_finish) & torch.isinf(task_finish0)
        requeue_count = requeue_count + requeued.to(_I32)
    eligible = tasks.submit <= t
    attempt = extras.get("attempt")
    attempt = launched if attempt is None else (attempt | launched)

    def first(old, cond):
        return torch.where((old == UNSET) & cond, rnd, old)

    # the round a task's finish time passes the clock, against the
    # post-advance time (a zero-duration launch finishes in-round)
    finished = new_state.task_finish <= rt.lift(new_state.t, new_state.task_finish)

    # placement identity: each launched task sits in the new worker_task
    # at its worker; the highest such worker wins (the reference's
    # in-order scatter), written into a pad slot T when there is none
    wt = new_state.worker_task
    B, W = wt.shape
    lw = rt.take(launched, torch.clamp(wt, max=T - 1)) & (wt < T)
    idx = torch.where(lw, wt, T).to(_I64)
    w_idx = torch.arange(W, dtype=_I32, device=wt.device).expand(B, W)
    winner = torch.full((B, T + 1), -1, dtype=_I32, device=wt.device).scatter_reduce(
        -1, idx, w_idx, "amax", include_self=True)[:, :T]
    placed = winner >= 0
    win = torch.clamp(winner, min=0)
    authority = extras.get("authority")
    if authority is None:
        gm = torch.zeros_like(win)
    else:
        gm = rt.take(authority.to(_I32), win)
    stale = extras.get("stale")
    stale_count = prov.stale_retry_count
    if stale is not None:
        stale_count = stale_count + stale.to(_I32)
    return Provenance(
        first_eligible_round=first(prov.first_eligible_round, eligible),
        first_attempt_round=first(prov.first_attempt_round, attempt),
        first_launch_round=first(prov.first_launch_round, launched),
        launch_round=torch.where(launched, rnd, prov.launch_round),
        finish_round=first(prov.finish_round, finished),
        requeue_count=requeue_count,
        stale_retry_count=stale_count,
        placed_gm=torch.where(placed, gm, prov.placed_gm),
        placed_worker=torch.where(placed, winner, prov.placed_worker),
    )


def critical_tasks(
    task_finish: torch.Tensor, t: torch.Tensor, tasks: TaskArrays
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cid int32[..., J], done bool[..., J]) — per job, the index of the
    task whose finish defines the job finish (ties break to the highest
    task index); ``cid`` is ``UNSET`` for unfinished jobs."""
    _, job_finish = rt.job_delays_from_state(task_finish, t, tasks)
    fin = torch.where(task_finish <= rt.lift(t, task_finish), task_finish, float("inf"))
    job64 = tasks.job.to(_I64)
    crit = torch.isfinite(fin) & (fin == job_finish[..., job64])
    T = tasks.num_tasks
    ids = torch.where(crit, torch.arange(T, dtype=_I32, device=fin.device), UNSET)
    lead = fin.shape[:-1]
    cid = torch.full(lead + (tasks.num_jobs,), UNSET, dtype=_I32, device=fin.device)
    cid = cid.scatter_reduce(-1, job64.expand(lead + (T,)), ids, "amax", include_self=True)
    return cid, cid != UNSET


def decompose_delays(
    prov: Provenance,
    task_finish: torch.Tensor,
    t: torch.Tensor,
    tasks: TaskArrays,
    dt: float,
) -> dict[str, torch.Tensor]:
    """Split each finished job's delay into the four components (float32
    ``[..., J]`` each, NaN for unfinished jobs), summing to the Eq. 2
    delay.  The attribution follows the job's critical (last-finishing)
    task:

      * ``eligible_wait``   — submit -> its first scheduler attempt,
        anchored inside [submit, start];
      * ``inconsistency_retry`` — ``stale_retry_count * dt``;
      * ``fault_rework``    — ``(launch_round - first_launch_round) * dt``;
      * ``placement_wait``  — the residual.

    Retry and rework are clipped into the remaining budget in sequence,
    in the reference's float32 order, so the components telescope to the
    total."""
    delays, _ = rt.job_delays_from_state(task_finish, t, tasks)
    cid, done = critical_tasks(task_finish, t, tasks)
    ci = torch.clamp(cid, 0, tasks.num_tasks - 1)
    submit = tasks.job_submit
    start = rt.take(task_finish, ci) - tasks.duration[ci.to(_I64)]
    d = torch.where(done, delays, 0.0)
    attempt_t = rt.take(prov.first_attempt_round, ci).to(torch.float32) * dt
    anchor = torch.minimum(torch.maximum(attempt_t, submit),
                           torch.maximum(start, submit))
    eligible = torch.minimum(torch.clamp(anchor - submit, min=0.0), d)
    retry_raw = rt.take(prov.stale_retry_count, ci).to(torch.float32) * dt
    retry = torch.minimum(torch.clamp(retry_raw, min=0.0), d - eligible)
    rework_raw = (rt.take(prov.launch_round, ci)
                  - rt.take(prov.first_launch_round, ci)).to(torch.float32) * dt
    rework = torch.minimum(torch.clamp(rework_raw, min=0.0), d - eligible - retry)
    placement = d - (eligible + retry + rework)
    nan = float("nan")
    return {
        "delays": delays,
        "eligible_wait": torch.where(done, eligible, nan),
        "placement_wait": torch.where(done, placement, nan),
        "inconsistency_retry": torch.where(done, retry, nan),
        "fault_rework": torch.where(done, rework, nan),
        "critical_task": cid,
    }
