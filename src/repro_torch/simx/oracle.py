"""Omniscient centralized oracle — the global-knowledge lower bound (port
of ``repro/simx/oracle.py``).

One centralized scheduler with perfect, instant knowledge of every worker
serves one global FIFO: each round every queued task in the head window is
matched onto the actually-free workers through the same rank-and-select
primitive, with the same launch hop costs as the real schedulers.  The gap
between a scheduler's p50/p95 job delay and the oracle's on the same trace
is its partial-knowledge cost.

Under faults the oracle plays by the same rules as everyone else: crashed
workers lose their in-flight task (re-pended through a FIFO-head rollback:
task ids are global FIFO positions) and read busy until recovery; perfect
knowledge means it never proposes onto a dead worker.  GM outages do not
apply (there are no GMs).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.simx import runtime as rt
from repro_torch.simx.faults import FaultSchedule
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.state import (
    OracleState,
    SimxConfig,
    TaskArrays,
    fifo_rows,
    init_oracle_state,
)


def make_oracle_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
) -> Callable[[OracleState], OracleState]:
    """Build the one-round transition function on ``tasks``' device, under
    the fault schedule ``faults`` if one is given.

    The global FIFO is the task-id order itself (``export_workload`` sorts
    tasks by job submit time), so the queue is a head pointer over
    ``arange(T)``; the oracle matches against ground truth, so every
    proposal launches.  The window is at least W wide (capped at T), so a
    single round can fill the entire datacenter.  The step is batched over
    grid points: one ``[B, W]`` match per round.

    ``telemetry`` adds the per-round ``launches`` counter; ``provenance``
    the extras ``attempt`` (the whole queued window was ranked) and
    ``authority`` 0, the one omniscient scheduler."""
    if match_fn is None:
        match_fn = default_match_fn()
    dev = tasks.device
    T = tasks.num_tasks
    C = int(min(max(cfg.num_workers, 64), max(T, 1)))
    # the FIFO: task ids in submit order, padded so the window never
    # leaves the row at head == T
    fifo = torch.cat([
        torch.arange(T, dtype=torch.int32, device=dev),
        torch.full((C,), T, dtype=torch.int32, device=dev),
    ])
    # one row of submit times per grid point (or one shared row)
    submit = tasks.submit.reshape(-1, T)
    submit_pad = torch.cat([submit, submit.new_full((submit.shape[0], 1), float("inf"))], -1)
    dur_pad = rt.pad_last(tasks.duration, 0.0)       # [T+1], or [L, T+1] in lanes
    if provenance:
        no_authority = torch.zeros(cfg.num_workers, dtype=torch.int32, device=dev)

    def dispatch(s, t, task_finish0, worker_finish0, free, comp, lost_w):
        del comp
        # -- 0. crash-loss rollback: a lost task's id is its FIFO position -
        head0 = s.head                                             # int32[B]
        if faults is not None:
            lost_t = torch.where(lost_w, s.worker_task, T)
            head0 = torch.minimum(head0, torch.amin(lost_t, dim=-1))

        # -- 1. queued window ----------------------------------------------
        wtask = rt.slice_rows(fifo, head0, C)                      # int32[B,C]
        wsub = torch.where(
            wtask >= T, float("inf"), rt.take(submit_pad, torch.clamp(wtask, max=T)),
        )
        fpad = rt.finish_pad(task_finish0)
        launched = rt.window_launched(fpad, wtask, T)              # bool[B,C]
        queued = ~launched & (wsub <= t[:, None])
        nq = torch.sum(queued, dim=-1, dtype=torch.int32)          # int32[B]
        fifo_pos = rt.sorted_fifo(queued, C)

        # -- 2. perfect match: FIFO ranks onto actually-free workers --------
        ranks = match_fn(free, nq)                                 # int32[B,W]
        sel_task = rt.select_from_window(ranks, fifo_pos, wtask, T)
        launch = sel_task < T

        # -- 3. launch: same hop costs as the real schedulers ---------------
        task_finish, worker_finish, worker_task = rt.apply_launch(
            launch, sel_task, t + 3 * cfg.hop, dur_pad,
            task_finish0, worker_finish0, s.worker_task, T,
        )
        messages = s.messages + torch.sum(launch, dim=-1, dtype=torch.int32)

        # -- 4. advance the head past the launched prefix -------------------
        fpad2 = rt.finish_pad(task_finish)
        launched2 = rt.window_launched(fpad2, wtask, T)
        head = torch.clamp(head0 + rt.launched_lead(launched2), max=T)

        upd = dict(
            task_finish=task_finish,
            worker_finish=worker_finish,
            worker_task=worker_task,
            head=head,
            messages=messages,
        )
        if telemetry:
            upd["telemetry"] = dict(launches=torch.sum(launch, dim=-1, dtype=torch.int32))
        if provenance:
            # written into a pad slot T that is cut off
            attempt = torch.zeros((t.shape[0], T + 1), dtype=torch.bool, device=dev).scatter(
                -1, torch.where(queued, wtask, T).to(torch.int64), True)[:, :T]
            upd["provenance"] = dict(attempt=attempt, authority=no_authority)
        return upd

    return rt.compose_step(cfg, tasks, dispatch, faults, telemetry, provenance)


def _build_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: dict,
    *,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: None = None,
) -> Callable:
    del draws, layout  # draws nothing; the window is its layout
    return make_oracle_step(cfg, tasks, match_fn, faults, telemetry, provenance)


def _stream_layout(cfg: SimxConfig, win) -> tuple[None, dict]:
    """No layout: the oracle's FIFO is the window's real tasks in order."""
    real = np.where(np.arange(win.T_cap) < win.T_real, 0, -1)
    return None, {"head": fifo_rows(real, 1, win.T_cap, win.T_cap)}


RULE = rt.register_rule(
    rt.Rule(
        name="oracle",
        init=lambda cfg, tasks, batch=None: init_oracle_state(
            cfg, tasks.num_tasks, tasks.device, batch),
        build_step=_build_step,
        stream_layout=_stream_layout,
    )
)
