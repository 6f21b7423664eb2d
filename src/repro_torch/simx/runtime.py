"""Shared round-stage runtime (port of ``repro/simx/runtime.py``).

Every rule advances the datacenter through the same round pipeline;
only the dispatch in the middle differs.  ``compose_step`` assembles it:

  1. **complete** — ``completion_masks``: ground-truth free/completed-now
     masks from ``worker_finish`` crossing the round time.
  2. **rule.dispatch** — the scheduler-specific stage, built from the
     windowed-FIFO helpers (``slice_rows``, ``sorted_fifo``,
     ``window_launched``, ``launched_lead``) and the launch bookkeeping
     (``apply_launch``); returns the state-field updates as a dict.
  3. **advance** — the runtime folds the updates into a new state and
     advances ``t``/``rnd``.

The reference's fault, telemetry and provenance stages are later slices
of the port; ``compose_step`` refuses them for now.

``jax.lax.scan`` becomes a Python loop (``scan_rounds``), and the
reference's ``mode="drop"`` scatters become scatters into a padded slot
that is sliced off again: torch has no drop mode, and clamping the index
would overwrite a real slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.kernels import match, ref
from repro_torch.simx.state import SimxConfig, TaskArrays

#: rank-and-select primitive: (avail bool[B, N], n int32[B]) -> ranks
#: int32[B, N] (rank of each selected column, -1 where unselected).
MatchFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def default_match_fn(use_kernel: bool = True) -> MatchFn:
    """The match primitive every rule ranks-and-selects with.

    ``use_kernel=True`` (the main path) is the kernel wrapper: the CUDA
    kernel for a tensor on the card, the plain version for one on the CPU.
    ``use_kernel=False`` is the plain version on any device, so that a run
    on the card can be held against the same run without the kernel."""
    return match.match_ranks_batched if use_kernel else ref.match_ranks_batched_ref


# ---------------------------------------------------------------------------
# stage helpers: windowed FIFOs, launch bookkeeping, completion masks
# ---------------------------------------------------------------------------


def slice_rows(mat: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row windows: row i of the result is ``mat[i, starts[i] :
    starts[i] + width]``.  The reference's ``dynamic_slice`` clamps a start
    that would leave the row; callers pad their rows by ``width`` so that
    never applies, and here an index past the row is an error of ``gather``
    rather than a silent clamp."""
    if mat.shape[-1] < width:
        raise ValueError(f"rows of width {mat.shape[-1]} cannot hold a {width}-wide window")
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        width, dtype=torch.int64, device=mat.device
    )
    return torch.gather(mat, 1, idx)


def sorted_fifo(queued: torch.Tensor, width: int) -> torch.Tensor:
    """Window positions of the queued entries in FIFO order (``width`` =
    none): sorting queued positions ahead of the ``width`` sentinels keeps
    task-index (== FIFO) order, so the r-th launch rank maps to
    ``sorted_fifo(...)[..., r]`` even when launched tasks punch holes."""
    pos = torch.arange(width, dtype=torch.int32, device=queued.device).expand(queued.shape)
    return torch.sort(torch.where(queued, pos, width), dim=-1).values


def finish_pad(task_finish: torch.Tensor) -> torch.Tensor:
    """``task_finish`` with a ``-inf`` pad slot so windowed gathers of the
    out-of-bounds sentinel task read as launched."""
    return torch.cat([task_finish, task_finish.new_full((1,), float("-inf"))])


def window_launched(fpad: torch.Tensor, wtask: torch.Tensor, num_tasks: int) -> torch.Tensor:
    """bool — which window entries are already launched (pad sentinels
    count as launched, so head advance can run through them)."""
    return ~torch.isinf(fpad[wtask.to(torch.int64)]) | (wtask >= num_tasks)


def launched_lead(launched: torch.Tensor) -> torch.Tensor:
    """int32 — length of each window's launched prefix (the amount the
    FIFO head pointer advances this round)."""
    lead = torch.cumprod(launched.to(torch.int32), dim=-1, dtype=torch.int32)
    return torch.sum(lead, dim=-1, dtype=torch.int32)


def select_from_window(
    ranks: torch.Tensor, fifo_pos: torch.Tensor, wtask: torch.Tensor, num_tasks: int
) -> torch.Tensor:
    """Map match ranks to window task ids: rank r serves the r-th queued
    window position (``sorted_fifo``), which indexes the window's task
    ids; unmatched lanes (rank < 0) read the ``num_tasks`` sentinel.  Works
    batched ([G, C] windows with [G, K] ranks) and flat ([C] with [W])."""
    width = fifo_pos.shape[-1]
    sel_pos = torch.gather(fifo_pos, -1, ranks.clamp(0, width - 1).to(torch.int64))
    sel = torch.gather(wtask, -1, sel_pos.clamp(0, width - 1).to(torch.int64))
    return torch.where(ranks >= 0, sel, num_tasks)


def apply_launch(
    launch: torch.Tensor,
    task_pick: torch.Tensor,
    start: torch.Tensor,
    dur_pad: torch.Tensor,
    task_finish: torch.Tensor,
    worker_finish: torch.Tensor,
    worker_task: torch.Tensor,
    num_tasks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply one phase's launches ([W]-space masks) to the task/worker
    state: the completion time is known at launch, so ``task_finish`` and
    ``worker_finish`` are both recorded as ``start + duration``.  Lanes
    that launch nothing write the pad slot ``num_tasks``, which is cut off
    (the reference's ``mode="drop"``)."""
    lt = torch.where(launch, task_pick, num_tasks).to(torch.int64)
    fin = start + dur_pad[torch.clamp(task_pick, max=num_tasks).to(torch.int64)]
    padded = torch.cat([task_finish, task_finish.new_zeros(1)])
    task_finish = padded.scatter(0, lt, fin)[:num_tasks]
    worker_finish = torch.where(launch, fin, worker_finish)
    worker_task = torch.where(launch, task_pick, worker_task)
    return task_finish, worker_finish, worker_task


def completion_masks(
    worker_finish: torch.Tensor, t: torch.Tensor, dt: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(free bool[W], completed-now bool[W]) ground truth at round start:
    free iff the recorded finish time has passed, completed-now iff it
    fell inside the round window just ended."""
    free = worker_finish <= t
    return free, free & (worker_finish > t - dt)


# ---------------------------------------------------------------------------
# the round pipeline
# ---------------------------------------------------------------------------

#: Dispatch stage: (state, t, task_finish0, worker_finish0, free, comp,
#: lost_w) -> dict of state-field updates (everything except t/rnd/lost,
#: which the runtime advances).  ``lost_w`` is always None until the fault
#: stage is ported.
DispatchFn = Callable[..., dict]

#: Round-index budget: ``rnd`` is int32, so a run may advance at most this
#: many rounds before the counter would wrap.
MAX_ROUND_BUDGET = 2**31 - 2**20


def check_round_budget(num_rounds: int, where: str = "scan_rounds") -> None:
    """Fail fast when a round budget would overflow the int32 round clock."""
    if num_rounds > MAX_ROUND_BUDGET:
        raise OverflowError(
            f"{where}: {num_rounds} rounds exceeds the int32 round-clock "
            f"budget ({MAX_ROUND_BUDGET}); the rnd counter would wrap "
            "silently. Split the run or raise dt."
        )


def compose_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    dispatch: DispatchFn,
    faults=None,
    telemetry: bool = False,
    provenance: bool = False,
) -> Callable:
    """Assemble one rule's round step: ``complete -> dispatch -> advance``.
    The fault, telemetry and provenance stages of the reference are not
    ported yet and raise ``NotImplementedError``."""
    if faults is not None or telemetry or provenance:
        raise NotImplementedError(
            "faults, telemetry and provenance are not ported yet "
            "(ROADMAP.md queue 1, items 7 and 10)"
        )
    del tasks

    def step(s):
        t = s.t
        free, comp = completion_masks(s.worker_finish, t, cfg.dt)
        updates = dispatch(s, t, s.task_finish, s.worker_finish, free, comp, None)
        return s.replace(t=t + cfg.dt, rnd=s.rnd + 1, **updates)

    return step


def scan_rounds(step: Callable, state, num_rounds: int):
    """Advance ``state`` by ``num_rounds`` rounds (``lax.scan`` as a loop)."""
    check_round_budget(num_rounds)
    for _ in range(num_rounds):
        state = step(state)
    return state


# ---------------------------------------------------------------------------
# the rule registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    """One scheduler of the simx matrix.

    ``build_step(cfg, tasks, generator, *, match_fn, orders)`` returns the
    round step; ``init(cfg, tasks)`` the fresh state on ``tasks``' device.
    ``generator`` is a ``torch.Generator`` for the rule's own random draws
    (megha's GM orders when ``orders`` is not given); ``needs_grid`` marks
    rules whose worker count must divide into the GM x LM grid."""

    name: str
    init: Callable[[SimxConfig, TaskArrays], Any]
    build_step: Callable[..., Callable]
    needs_grid: bool = False


#: name -> Rule, in registration order.
RULES: dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    """Register a scheduler rule; every entry point picks it up."""
    if rule.name in RULES:
        raise ValueError(f"rule {rule.name!r} already registered")
    RULES[rule.name] = rule
    return rule


def get_rule(name: str) -> Rule:
    try:
        return RULES[name.lower()]
    except KeyError:
        raise ValueError(
            f"the port's simx backend implements {tuple(RULES)}, not {name!r}"
        ) from None


# ---------------------------------------------------------------------------
# the shared job-delay reduction (Eq. 2)
# ---------------------------------------------------------------------------


def job_delays_from_state(
    task_finish: torch.Tensor, t: torch.Tensor, tasks: TaskArrays
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-job Eq. 2 delays from the state.

    A task is done iff its recorded finish time has passed ``t``; a job
    finishes at its last task's finish.  Returns ``(delays float32[J],
    job_finish float32[J])`` with ``delays = finish - submit - ideal``,
    nan for unfinished jobs (``job_finish`` reads ``+/-inf`` there)."""
    fin = torch.where(task_finish <= t, task_finish, float("inf"))
    j = tasks.num_jobs
    # the max-scatter gets a pad slot, as the reference's scatter drops
    # out-of-range rows (there are none: every task belongs to a job)
    job_finish = torch.full(
        (j + 1,), float("-inf"), dtype=torch.float32, device=fin.device
    ).scatter_reduce(0, tasks.job.to(torch.int64), fin, "amax", include_self=True)[:j]
    delays = job_finish - tasks.job_submit - tasks.job_ideal
    delays = torch.where(torch.isfinite(job_finish), delays, float("nan"))
    return delays, job_finish
