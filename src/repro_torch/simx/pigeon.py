"""Pigeon transition rule for the simx round-stepped backend (port of
``repro/simx/pigeon.py``, with the streaming engine's ``PigeonLayout``).

Federated two-layer scheduling (paper §2.2.4) over dense per-group arrays:

  * **Static distribution** — the event backend's distributors spread each
    job's tasks round-robin (task by task, persistent per-distributor
    counters, jobs round-robin over distributors).  That mapping depends
    only on the trace, so the task -> group assignment is precomputed
    exactly, in numpy, at step-build time (``task_groups``).
  * **Per-group FIFOs** — each group holds a high-priority (short job) and
    a low-priority (long job) FIFO.  Tasks arrive in submit order, groups
    launch strictly from the FIFO head, so each queue is a windowed head
    pointer over a compact per-group task layout; coordinators know their
    own group, so every proposal launches.
  * **Reserved workers** — the first ``reserved_per_group`` workers of each
    group serve high-priority tasks only; high tasks prefer unreserved
    workers, low tasks never touch reserved ones.
  * **WFQ** — unreserved capacity is split between the two queues by the
    reference's closed-form weighted-fair-queuing allocation: per
    ``wfq_weight`` high-priority launches, one low-priority launch, with
    the carried ``since_low`` counter preserving the pattern phase across
    rounds.

A task assigned to a group never migrates, so it queues even when other
groups have idle workers (the pathology Megha fixes).  Pigeon draws no
random numbers, so the port's runs are bitwise the reference's.  Both
matches of a round (unreserved and reserved workers) go through the
rank-and-select primitive over ``[B * NG, S]`` rows: at the paper's 50,000
workers, 1,250 groups of 40.  The step reads its per-group class FIFOs
from a ``PigeonLayout``, which ``pigeon_layout`` builds for a fixed trace
when the step is built and for the streaming engine's window
(``repro_torch.simx.stream``, from its persistent distributor counters)
at every refill, which passes it in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.simx import runtime as rt
from repro_torch.simx.faults import FaultSchedule
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.state import (
    FifoRows,
    PigeonState,
    SimxConfig,
    TaskArrays,
    fifo_rows,
    init_pigeon_state,
    spec,
)


def task_groups(cfg: SimxConfig, tasks: TaskArrays) -> np.ndarray:
    """int[T] — the group each task is distributed to, replicating the
    event backend's persistent per-distributor round-robin exactly (a
    copy of ``repro.simx.pigeon.task_groups``)."""
    NG, D = cfg.num_groups, cfg.num_distributors
    ntasks = tasks.job_ntasks.cpu().numpy()
    rr = np.arange(D, dtype=np.int64)  # each distributor decorrelates its start
    out = np.empty(tasks.num_tasks, np.int32)
    k = 0
    for p in range(tasks.num_jobs):
        d = p % D
        c = int(ntasks[p])
        out[k : k + c] = (rr[d] + np.arange(c)) % NG
        rr[d] += c
        k += c
    return out


@dataclass(frozen=True)
class PigeonLayout:
    """Pigeon's per-group FIFOs (the reference's ``PigeonLayout``), built by
    ``pigeon_layout`` for a fixed trace and for the streaming window alike.
    Rows list each group's task ids per priority class in submit order
    (the group of a task comes from the distributors' round-robin, whose
    counters the stream keeps across refills, so a refill never
    re-distributes a task), padded with the sentinel ``T`` and by the
    window C = max(S, 1); ``len_high`` / ``len_low`` clamp the heads."""

    high_fifo: torch.Tensor = spec("int32[NG, ?]")  # rows: capacity + C
    low_fifo: torch.Tensor = spec("int32[NG, ?]")
    len_high: torch.Tensor = spec("int32[NG]")
    len_low: torch.Tensor = spec("int32[NG]")


def _group_sizes(cfg: SimxConfig) -> np.ndarray:
    """int64[NG]: contiguous worker ranges, the last group absorbing the
    remainder."""
    sizes = np.full(cfg.num_groups, cfg.group_size, np.int64)
    sizes[-1] = cfg.num_workers - (cfg.num_groups - 1) * cfg.group_size
    return sizes


def pigeon_layout(cfg: SimxConfig, task_group: np.ndarray, high: np.ndarray, device,
                  capacity: int | None = None) -> tuple[PigeonLayout, tuple[FifoRows, ...]]:
    """The per-group class FIFOs of a task set (``task_group`` int[T]: each
    task's group, -1 for none; T the sentinel; ``high`` marks the short
    jobs' tasks) and their host rows (high, low).  Rows hold ``capacity``
    tasks plus the window C = max(S, 1).  The stream passes the most one
    group can hold, and the lengths are the real ones; a fixed trace
    passes None, and each class's longest row (0 for an empty class) is
    both the capacity and every row's length, as the reference clamps."""
    NG = cfg.num_groups
    C = max(int(_group_sizes(cfg).max()), 1)
    fifos, lens = [], []
    for mask in (high, ~high):
        row = np.where(mask, task_group, -1)
        cap = (int(np.bincount(row[row >= 0], minlength=NG).max())
               if capacity is None else capacity)
        fifos.append(fifo_rows(row, NG, cap + C, task_group.size))
        lens.append(np.full(NG, cap, np.int32) if capacity is None else fifos[-1].lens)
    hi, lo = fifos
    # high_fifo, low_fifo, len_high, len_low
    return PigeonLayout(*(torch.from_numpy(a).to(device)
                          for a in (hi.rows, lo.rows, *lens))), (hi, lo)


def make_pigeon_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[PigeonLayout] = None,
) -> Callable[[PigeonState], PigeonState]:
    """Build the one-round transition function on ``tasks``' device.

    Round order: completions (implicit via ``worker_finish``) -> WFQ split
    of each group's free unreserved workers between its high/low queue
    heads -> high overflow onto reserved workers -> launch + head advance.
    The step is batched over grid points (``runtime``'s point axis).

    With ``faults``, crashed workers lose their in-flight task (the group's
    high/low head rolls back so the FIFO re-examines it) and read busy
    until recovery, which shrinks the group's capacity: tasks can NOT
    migrate groups, so a decimated group queues until its workers return.
    Because rolled-back windows contain already-launched tasks, the fault
    build swaps the submitted-prefix queue count for an explicit unlaunched
    mask and sorted FIFO positions, and advances heads past the launched
    prefix; without rollbacks both forms coincide, so an empty schedule is
    bitwise the ``faults=None`` step.

    ``telemetry`` adds the per-round ``launches`` and ``reserve_hits``
    (high tasks placed on reserved workers) counters; ``provenance`` the
    extras ``attempt`` (the task sat in its group's queued window) and
    ``authority`` (the group coordinator, static per worker).

    ``layout`` (a ``PigeonLayout``, the streaming window's) holds the class
    FIFOs the step reads; without one the step builds the fixed trace's
    with ``pigeon_layout``.  A given layout does not compose with a fault
    schedule.  Lane-stacked windows (every ``tasks`` field and layout
    tensor ``[L, ...]``) step L = B lanes."""
    if match_fn is None:
        match_fn = default_match_fn()
    if layout is not None and faults is not None:
        raise NotImplementedError(
            "streaming layout does not compose with fault schedules"
        )
    dev = tasks.device
    W = cfg.num_workers
    T = tasks.num_tasks
    NG = cfg.num_groups
    weight = cfg.wfq_weight
    # -- worker grid [NG, S]: contiguous ranges, last group absorbs the
    #    remainder, pad slots get the W sentinel (they read busy)
    sizes = _group_sizes(cfg)[:, None]
    S = int(sizes.max())
    col = np.arange(S)
    wg_np = np.where(col < sizes, np.arange(NG)[:, None] * cfg.group_size + col, W)
    wg = torch.from_numpy(wg_np).to(dev)[None]                # int64[1, NG, S]
    reserved = torch.from_numpy(col < np.minimum(cfg.reserved_per_group, sizes)).to(dev)
    if provenance:
        # static worker -> group map (the provenance authority)
        worker_group = torch.from_numpy(np.minimum(
            np.arange(W) // cfg.group_size, NG - 1).astype(np.int32)).to(dev)
    C = max(S, 1)  # window width: a group launches at most S tasks per round
    if not layout:
        # a fixed trace: the exact static task -> group distribution, split
        # by priority class
        gt = task_groups(cfg, tasks)
        high_task = (tasks.job_est.cpu().numpy()[tasks.job.cpu().numpy()]
                     < cfg.long_threshold)
        layout, (hi, lo) = pigeon_layout(cfg, gt, high_task, dev)
    # [NG, ...] rows, or [L, NG, ...] for lane-stacked windows
    high_fifo, low_fifo = layout.high_fifo.to(dev), layout.low_fifo.to(dev)
    if high_fifo.dim() == 2:
        high_fifo, low_fifo = high_fifo[None], low_fifo[None]
    len_h, len_l = layout.len_high.to(dev), layout.len_low.to(dev)
    # one row of submit times per grid point (or one shared row)
    submit = tasks.submit.reshape(-1, T)                       # [Bt, T]
    submit_pad = torch.cat([submit, submit.new_full((submit.shape[0], 1), float("inf"))], -1)
    dur_pad = rt.pad_last(tasks.duration, 0.0)               # [T+1] or [L, T+1]
    if faults is not None:
        # task -> (group, FIFO position, class) for crash-loss head rollback;
        # the T pad routes to the pad group NG, which is cut off
        task_pos_pad = torch.from_numpy(
            np.append(np.where(high_task, hi.pos, lo.pos), np.int32(0))).to(dev)
        grp_pad = torch.from_numpy(np.append(gt, NG).astype(np.int64)).to(dev)
        high_pad = torch.from_numpy(np.append(high_task, False)).to(dev)

    def window(fifo, heads, t):
        """Window task ids + queued counts.  Launches are strictly FIFO and
        the head fully advances every round, so the window never contains a
        launched task and 'queued' is just the submitted prefix."""
        wtask = rt.slice_rows(fifo, heads, C)                  # int32[B,NG,C]
        wsub = torch.where(
            wtask >= T, float("inf"), rt.take(submit_pad, torch.clamp(wtask, max=T)))
        return wtask, torch.sum(wsub <= t[:, None, None], dim=-1, dtype=torch.int32)

    def window_fault(fifo, heads, t, task_finish):
        """Fault-mode window: a rolled-back head re-examines launched tasks,
        so 'queued' needs the explicit unlaunched mask and rank -> task
        goes through sorted queued positions (megha's FIFO recovery)."""
        wtask = rt.slice_rows(fifo, heads, C)                  # int32[B,NG,C]
        wsub = torch.where(
            wtask >= T, float("inf"), rt.take(submit_pad, torch.clamp(wtask, max=T)))
        launched = ~torch.isinf(rt.take(rt.finish_pad(task_finish), wtask))  # pad: False
        queued = ~launched & (wsub <= t[:, None, None])
        return (wtask, torch.sum(queued, dim=-1, dtype=torch.int32),
                rt.sorted_fifo(queued, C))

    def dispatch(s, t, task_finish0, worker_finish0, free_w, comp, lost_w):
        del comp  # completions stay implicit in the group capacity
        B = t.shape[0]
        # -- 0. crash-loss rollback (the fault stage ran in the runtime) ----
        high_head0, low_head0 = s.high_head, s.low_head
        if faults is not None:
            # re-enqueue lost tasks: roll the owning group's class FIFO back
            lt0 = torch.where(lost_w, s.worker_task, T).to(torch.int64)
            g0, p0, hi0 = grp_pad[lt0], task_pos_pad[lt0], high_pad[lt0]
            high_head0 = rt.rollback_heads(high_head0, torch.where(hi0, g0, NG), p0)
            low_head0 = rt.rollback_heads(low_head0, torch.where(hi0, NG, g0), p0)

        # -- 1. free capacity per group (the runtime's completion stage,
        #       gathered into the [NG, S] group grid; pads read busy) -------
        free_pad = torch.cat([free_w, free_w.new_zeros((B, 1))], -1)
        free = rt.take(free_pad, wg)                             # bool[B,NG,S]
        free_u = free & ~reserved
        free_r = free & reserved
        nfu = torch.sum(free_u, dim=-1, dtype=torch.int32)       # int32[B,NG]
        nfr = torch.sum(free_r, dim=-1, dtype=torch.int32)

        # -- 2. queued counts + WFQ split of unreserved capacity ------------
        if faults is None:
            wh, qh = window(high_fifo, high_head0, t)
            wl, ql = window(low_fifo, low_head0, t)
        else:
            wh, qh, fifo_h = window_fault(high_fifo, high_head0, t, task_finish0)
            wl, ql, fifo_l = window_fault(low_fifo, low_head0, t, task_finish0)
        total_u = torch.minimum(nfu, qh + ql)
        lead = torch.clamp(weight - s.since_low, min=0)  # highs before first low
        low_wfq = torch.where(
            total_u > lead, 1 + torch.div(total_u - lead - 1, weight + 1, rounding_mode="floor"), 0
        )
        n_low = torch.minimum(
            torch.maximum(low_wfq, torch.clamp(total_u - qh, min=0)),
            torch.minimum(ql, total_u),
        )
        n_high_u = total_u - n_low
        n_high_r = torch.minimum(qh - n_high_u, nfr)  # overflow onto reserved
        since_low = torch.clamp(s.since_low + n_high_u - weight * n_low, min=0)

        # -- 3. rank-and-select free workers, map ranks to FIFO positions ---
        S_ = free.shape[-1]
        ranks_u = match_fn(free_u.reshape(B * NG, S_), (n_high_u + n_low).reshape(B * NG))
        ranks_r = match_fn(free_r.reshape(B * NG, S_), n_high_r.reshape(B * NG))
        ranks_u = ranks_u.reshape(B, NG, S_)                     # int32[B,NG,S]
        ranks_r = ranks_r.reshape(B, NG, S_)
        nhu = n_high_u[..., None]
        if faults is None:
            # no holes: the r-th queued task sits at window position r
            pos_uh, pos_ul, pos_r = ranks_u, ranks_u - nhu, nhu + ranks_r
        else:
            # rank -> sorted queued position -> window task id
            pos_uh = rt.take(fifo_h, ranks_u.clamp(0, C - 1))
            pos_ul = rt.take(fifo_l, (ranks_u - nhu).clamp(0, C - 1))
            pos_r = rt.take(fifo_h, (nhu + ranks_r).clamp(0, C - 1))
        task_u = torch.where(
            ranks_u < 0,
            T,
            torch.where(
                ranks_u < nhu,
                torch.gather(wh, -1, pos_uh.clamp(0, C - 1).to(torch.int64)),
                torch.gather(wl, -1, pos_ul.clamp(0, C - 1).to(torch.int64)),
            ),
        )
        task_r = torch.where(
            ranks_r < 0,
            T,
            torch.gather(wh, -1, pos_r.clamp(0, C - 1).to(torch.int64)),
        )
        task_g = torch.minimum(task_u, task_r)  # disjoint slots: one is T
        launch = task_g < T                                         # [B,NG,S]

        # -- 4. launch: client->distributor->coordinator->worker = 3 hops;
        #       lanes that launch nothing write the pad slot, cut off -------
        start = t + 3 * cfg.hop
        fin = start[:, None, None] + rt.take(dur_pad, torch.clamp(task_g, max=T))
        fin = fin.reshape(B, -1)
        lt = torch.where(launch, task_g, T).reshape(B, -1).to(torch.int64)
        lw = torch.where(launch, wg, W).reshape(B, -1)
        task_finish = torch.cat(
            [task_finish0, task_finish0.new_zeros((B, 1))], -1).scatter(-1, lt, fin)[:, :T]
        worker_finish = torch.cat(
            [worker_finish0, worker_finish0.new_zeros((B, 1))], -1).scatter(-1, lw, fin)[:, :W]
        worker_task = torch.cat(
            [s.worker_task, s.worker_task.new_zeros((B, 1))], -1
        ).scatter(-1, lw, task_g.reshape(B, -1))[:, :W]
        # messages: one distributor->coordinator per arriving task, one
        # coordinator->worker per launch
        tt = t[:, None]
        arrived = torch.sum((submit > tt - cfg.dt) & (submit <= tt), dim=-1, dtype=torch.int32)
        messages = s.messages + arrived + torch.sum(launch, dim=(1, 2), dtype=torch.int32)

        # -- 5. head advance ------------------------------------------------
        if faults is None:
            # strict FIFO launches: advance by the launch counts
            high_head = torch.clamp(high_head0 + n_high_u + n_high_r, max=len_h)
            low_head = torch.clamp(low_head0 + n_low, max=len_l)
        else:
            # rolled-back windows have holes: advance past the launched
            # prefix instead (equal to the counts whenever there are none).
            # Pads read NOT launched here (unlike ``rt.window_launched``):
            # the head stops at the real tail instead of running through
            # the pad slots.
            fpad2 = rt.finish_pad(task_finish)
            lead_h = rt.launched_lead(~torch.isinf(rt.take(fpad2, wh)))
            lead_l = rt.launched_lead(~torch.isinf(rt.take(fpad2, wl)))
            high_head = torch.clamp(high_head0 + lead_h, max=len_h)
            low_head = torch.clamp(low_head0 + lead_l, max=len_l)

        upd = dict(
            task_finish=task_finish,
            worker_finish=worker_finish,
            worker_task=worker_task,
            high_head=high_head,
            low_head=low_head,
            since_low=since_low,
            messages=messages,
        )
        if telemetry:
            upd["telemetry"] = dict(
                launches=torch.sum(launch, dim=(1, 2), dtype=torch.int32),
                reserve_hits=torch.sum(n_high_r, dim=-1, dtype=torch.int32))
        if provenance:
            # attempt = the task sat in its group coordinator's queued
            # window: the submitted prefix, or the explicit queued mask
            # under fault rollbacks; written into a pad slot T, cut off
            if faults is None:
                col = torch.arange(C, dtype=torch.int32, device=dev)
                att_h, att_l = col < qh[..., None], col < ql[..., None]
            else:
                fpad_a = rt.finish_pad(task_finish0)
                tt3 = t[:, None, None]

                def queued_at(w):
                    wsub = torch.where(
                        w >= T, float("inf"), rt.take(submit_pad, torch.clamp(w, max=T)))
                    return torch.isinf(rt.take(fpad_a, w)) & (wsub <= tt3)

                att_h, att_l = queued_at(wh), queued_at(wl)
            idx = torch.cat([torch.where(att_h, wh, T).reshape(B, -1),
                             torch.where(att_l, wl, T).reshape(B, -1)], -1).to(torch.int64)
            attempt = torch.zeros((B, T + 1), dtype=torch.bool, device=dev).scatter(
                -1, idx, True)[:, :T]
            upd["provenance"] = dict(attempt=attempt, authority=worker_group)
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
    layout: Optional[PigeonLayout] = None,
) -> Callable:
    del draws  # draws nothing
    return make_pigeon_step(cfg, tasks, match_fn, faults, telemetry, provenance, layout)


def _stream_layout(cfg: SimxConfig, win) -> tuple[PigeonLayout, dict]:
    """The window's per-group class FIFOs, from the groups each job drew at
    admission.  A job spreads its n tasks round-robin over the groups, so
    one group holds at most ceil(n / NG) of each: rows of T_cap // NG plus
    one per window job, rather than the reference's T_cap (1,250 x
    196,608 slots a class at 50,000 workers); no result depends on it."""
    task_group = np.full(win.T_cap, -1, np.int64)
    if win.jobs:
        task_group[: win.T_real] = np.concatenate([wj.groups for wj in win.jobs])
    high = win.per_task(np.array([wj.est < cfg.long_threshold for wj in win.jobs], bool), False)
    capacity = min(win.T_cap, win.T_cap // cfg.num_groups + win.window_jobs)
    layout, (hi, lo) = pigeon_layout(cfg, task_group, high, win.device, capacity)
    return layout, {"high_head": hi, "low_head": lo}


RULE = rt.register_rule(
    rt.Rule(
        name="pigeon",
        init=lambda cfg, tasks, batch=None: init_pigeon_state(
            cfg, tasks.num_tasks, tasks.device, batch),
        build_step=_build_step,
        stream_layout=_stream_layout,
    )
)
