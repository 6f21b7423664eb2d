"""Eagle transition rule for the simx round-stepped backend (port of
``repro/simx/eagle.py``, with the streaming engine's ``EagleLayout``).

Hybrid scheduling with Succinct State Sharing (SSS) and sticky batch
probing (paper §2.2.3), over dense tensors:

  * **Long path** — jobs with ``estimated >= long_threshold`` feed one
    central FIFO over the *long partition* (workers ``[R, W)``, ``R =
    cfg.short_reserved``).  Each round the central scheduler matches its
    queued window onto the free long-partition workers, lowest index
    first, with the rank-and-select primitive: one ``[B, W]`` match, the
    kernel wrapper's wide design.
  * **Short path** — sparrow's batch sampling with late binding over ALL
    workers, refined by SSS at probe time: a probe landing on a worker
    running a long task is re-routed once to a per-job rotation of its
    target, and, if rejected again, into the short partition, which never
    runs long tasks.
  * **Sticky batch draining** — a worker finishing a task of job ``j``
    pulls ``j``'s next pending task at once (no probe, no hop).

Short-job reservations live in sparrow's capped per-worker queues
(``repro_torch.simx.sparrow``); SSS is evaluated per edge at insertion.
Whether the SSS and central stages exist is decided when the step is
built, as in the reference: a trace with no long job (the synthetic Fig. 2
trace, every estimate 1 s) leaves both out, and the round's only match is
the head-of-queue pick.  Under a fault schedule SSS stays in even then,
since it also bounces probes off dead workers, so on the Fig. 4 grid eagle
no longer binds as sparrow does.

The reference draws the probe targets and the two re-route rotations
(``off1``, ``off2``) with ``jax.random`` when it builds the step; here
they are the rule's draws, an argument, drawn from a ``torch.Generator``
(``draw``) when not fed in.  Every step is batched over grid points.
Under the streaming engine (``repro_torch.simx.stream``) the edge list,
the rotations and the central FIFO are an argument (``EagleLayout``),
sampled on the host per job at admission, and SSS and the central match
are always built in (a refill may bring long jobs into any window).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import queues
from repro_torch.kernels import tasks as task_axis
from repro_torch.simx import runtime as rt
from repro_torch.simx.faults import FaultSchedule, worker_dead
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.sparrow import (
    ProbeLayout,
    build_probe_edges,
    insert_probes,
    late_bind,
    probe_attempt,
    probe_mask,
    probe_targets,
    probe_window_slice,
    queue_head_pick,
)
from repro_torch.simx.state import (
    EagleState,
    FifoRows,
    SimxConfig,
    TaskArrays,
    fifo_rows,
    init_eagle_state,
    probe_edge_layout,
    spec,
)

_I32, _I64 = torch.int32, torch.int64


def eagle_probe_mask(targets: torch.Tensor, cfg: SimxConfig, tasks: TaskArrays) -> torch.Tensor:
    """bool[J, W] — each *short* job's initial probe targets (the dense
    ``sparrow.probe_mask`` of a target table); long-job rows are empty.
    A dense view for tests: the rule works per edge."""
    short = tasks.job_est < cfg.long_threshold
    return probe_mask(targets, cfg, tasks) & short[:, None]


@dataclass(frozen=True)
class EagleLayout:
    """Eagle's layout (the reference's ``EagleLayout``), built by
    ``eagle_layout`` for a fixed trace and for the streaming window alike:
    the short-path probe edges (a ``ProbeLayout``; long jobs get no edges),
    the per-job SSS re-route rotations (the stream samples them per
    *global* job id at admission, so carried jobs keep them across
    refills) and the central long FIFO.  ``long_fifo`` lists the long task
    ids in submit order padded with the sentinel ``T``; ``n_long`` (a
    tensor: it changes at every refill) clamps the central head;
    ``long_window`` is the static central match window CL the FIFO was
    padded for."""

    probes: ProbeLayout
    off1: torch.Tensor = spec("int32[J]")
    off2: torch.Tensor = spec("int32[J]")
    long_fifo: torch.Tensor = spec("int32[?]")  # capacity + long_window ids
    n_long: torch.Tensor = spec("int32[]")
    long_window: int = 1


def eagle_layout(cfg: SimxConfig, probes: ProbeLayout, off1: torch.Tensor, off2: torch.Tensor,
                 task_long: np.ndarray, device,
                 capacity: int | None = None) -> tuple[EagleLayout, FifoRows]:
    """Eagle's layout of a task set: the probe edges and rotations as
    given, and the central FIFO of the long tasks (``task_long`` bool[T]; T
    the sentinel) built here, with its host row.  It holds ``capacity``
    tasks (the stream's task slots; None: the long-task count) plus the
    window CL = min(max(capacity, 1), max(W - R, 64))."""
    cap = int(np.count_nonzero(task_long)) if capacity is None else capacity
    CL = min(max(cap, 1), max(cfg.num_workers - cfg.short_reserved, 64))
    fifo = fifo_rows(np.where(task_long, 0, -1), 1, cap + CL, task_long.size)
    return EagleLayout(probes, off1, off2, torch.from_numpy(fifo.rows[0]).to(device),
                       torch.tensor(int(fifo.lens[0]), dtype=_I32, device=device), CL), fifo


def make_eagle_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: dict | None,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[EagleLayout] = None,
) -> Callable[[EagleState], EagleState]:
    """Build the one-round transition function on ``tasks``' device, under
    the fault schedule ``faults`` if one is given.

    ``draws`` holds the short jobs' probe-target table ``targets``
    (``int32[J, kmax]``, kmax of the short jobs' edges) and the per-job
    re-route rotations ``off1`` (in ``[0, W)``) and ``off2`` (in ``[0,
    R)``), each with an optional leading point axis.

    Round order: completions (implicit) -> queue recycling/compaction ->
    windowed probe insertion with per-edge SSS re-routing -> sticky serve
    (completed workers continue their previous job) -> late binding (idle
    workers serve their queue heads, orphans rescued) -> central long
    match -> advance the central FIFO head.  ``match_fn`` drives both the
    narrow ``[B * W, R_q]`` pick and the wide ``[B, W]`` central match.

    With ``faults``, crashed workers lose their in-flight task (lost long
    tasks roll the central FIFO head back; lost shorts simply re-pend) and
    read busy until recovery; SSS also bounces probe edges off dead
    workers, and orphan rescue counts only reservations on live workers.
    ``faults=None`` builds the fault-free step; an empty schedule is
    bitwise the same run.

    ``telemetry`` adds the per-round ``launches`` and ``sss_rejections``
    counters; ``provenance`` the extras ``attempt`` (short-path probes
    inserted or orphan-rescued, or the long task in the central queued
    window) and ``authority`` (the job's home scheduler, ``job % num_gms``,
    for short jobs, entity ``num_gms`` for the central scheduler).

    ``layout`` (an ``EagleLayout``, the streaming window's) replaces the
    draws (pass None); without one the step builds the fixed trace's with
    ``eagle_layout`` from the draws.  With a given layout SSS and the
    central match are always built in; it does not compose with a fault
    schedule.  Lane-stacked windows (every ``tasks`` field and layout
    tensor ``[L, ...]``) step L = B lanes."""
    if match_fn is None:
        match_fn = default_match_fn()
    dev = tasks.device
    W, T, J = cfg.num_workers, tasks.num_tasks, tasks.num_jobs
    R = cfg.short_reserved
    if layout is not None and faults is not None:
        raise NotImplementedError(
            "streaming layout does not compose with fault schedules"
        )
    # a refill may bring long jobs into any window: with a given layout
    # both long-path stages stay built in, clamped by the window's count
    use_central = True
    if not layout:
        # a fixed trace: the draws' probe edges and rotations
        *edges, _, C = build_probe_edges(draws["targets"], cfg, tasks, short_only=True)
        task_long = (tasks.job_est.cpu().numpy()[tasks.job.cpu().numpy()]
                     >= cfg.long_threshold)
        layout, fifo = eagle_layout(cfg, ProbeLayout(*edges, C), draws["off1"], draws["off2"],
                                    task_long, dev)
        # structural, as in the reference: a trace with no long job has no
        # central queue, and no SSS rejections unless dead workers bounce
        # probes, so those stages are left out
        use_central = bool(fifo.lens[0])
    use_sss = use_central or faults is not None
    pl = layout.probes
    edge_job, edge_worker, edge_end = (
        pl.edge_job.to(dev), pl.edge_worker.to(dev), pl.edge_end.to(dev))
    C = pl.window
    off1 = layout.off1.to(device=dev, dtype=_I32)
    off2 = layout.off2.to(device=dev, dtype=_I32)
    long_fifo = layout.long_fifo.to(dev)
    CL = layout.long_window
    NL = layout.n_long.to(dev)
    short_job = tasks.job_est < cfg.long_threshold              # bool[J] ([L, J] in lanes)
    long_task = rt.pad_last(~rt.take(short_job, tasks.job), False)   # bool[T+1]
    job_pad = rt.pad_last(tasks.job, J)
    dur_pad = rt.pad_last(tasks.duration, 0.0)
    submit = tasks.submit.reshape(-1, T)
    submit_pad = torch.cat([submit, submit.new_full((submit.shape[0], 1), float("inf"))], -1)
    job_submit = tasks.job_submit.reshape(-1, J)
    job_submit_pad = torch.cat([job_submit, job_submit.new_full((job_submit.shape[0], 1),
                                                                float("inf"))], -1)
    w_row = torch.arange(W, dtype=_I32, device=dev)
    j_idx = torch.arange(J, dtype=_I32, device=dev)
    long_partition = w_row >= R
    if faults is not None:
        # task -> central-FIFO position for crash-loss head rollback
        # (short tasks and the T pad map to NL: the min below ignores them)
        n_long = int(fifo.lens[0])
        long_pos = torch.from_numpy(np.append(
            np.where(task_long, fifo.pos, n_long), n_long).astype(np.int32)).to(dev)

    def apply_launch(launch, task_pick, start, task_finish, worker_finish, worker_task):
        return rt.apply_launch(launch, task_pick, start, dur_pad,
                               task_finish, worker_finish, worker_task, T)

    def dispatch(s, t, task_finish0, worker_finish0, free, comp, lost_w):
        del free  # idleness is re-derived after the sticky launches
        B = t.shape[0]
        tt = t[:, None]
        long_head = s.long_head
        dead = None
        if faults is not None:
            # lost long tasks re-enter the central FIFO: roll the head back
            if use_central:
                lt0 = torch.where(lost_w, s.worker_task, T).to(_I64)
                long_head = torch.minimum(long_head, torch.amin(long_pos[lt0], dim=-1))
            dead = worker_dead(faults, t)                         # bool[B,W]
        long_here = (worker_finish0 > tt) & rt.take(long_task, s.worker_task)   # [B,W]

        # -- 0. one pass over the tasks (per-job unfinished and pending
        # counts, the pending list), then recycle completed jobs' slots and
        # compact the queues
        unfinished, pending, plist = task_axis.task_scan(task_finish0, submit, tasks.job, t, J)
        buf, fill = queues.queue_compact(s.resq, unfinished)

        # -- 1. windowed probe insertion with per-edge SSS re-routing -------
        win_j, win_w, lead, ins, lagged = probe_window_slice(
            edge_job, edge_worker, s.probe_head, C, job_submit_pad, t)
        if use_sss:
            # SSS also bounces probes off dead workers (the RPC times out)
            sss_reject = long_here if dead is None else long_here | dead
            wj = torch.clamp(win_j, 0, max(J - 1, 0))
            rej0 = ins & rt.take(sss_reject, torch.clamp(win_w, 0, W - 1))
            w1 = torch.where(rej0, (win_w + rt.take(off1, wj)) % W, win_w)
            rej1 = rej0 & rt.take(sss_reject, w1)
            wfin = torch.where(rej1, (w1 + rt.take(off2, wj)) % R, w1)
            n_rej = (torch.sum(rej0, dim=-1, dtype=_I32)
                     + torch.sum(rej1, dim=-1, dtype=_I32))
        else:
            wfin = win_w
            n_rej = torch.zeros_like(lead) if telemetry else 0
        resq, n_over = insert_probes(buf[:-1].view(s.resq.shape), fill, wfin, win_j, ins,
                                     buf=buf)
        head = s.probe_head + lead
        probes = s.probes + lead + n_rej
        messages = s.messages + lead + 2 * n_rej                  # reject + resend

        # -- 2. sticky batch draining: completed workers keep their job -----
        prev_job = rt.take(job_pad, s.worker_task)                # int32[B,W], J = none
        sticky_pick = torch.where(comp & (rt.take(pending, prev_job) > 0), prev_job, J)
        launch1, task1 = late_bind(sticky_pick, pending, plist)
        # the worker already holds the job's spec: no extra hops
        task_finish, worker_finish, worker_task = apply_launch(
            launch1, task1, t, task_finish0, worker_finish0, s.worker_task)

        # -- 3. late binding: idle workers serve their queue heads ----------
        # (the pending counts and list again, after the sticky launches)
        _, pending, plist = task_axis.task_scan(task_finish, submit, tasks.job, t, J)
        idle = worker_finish <= tt
        active, has_res = queues.queue_scan(resq, pending, row_mask=idle, dead=dead)
        job_pick = queue_head_pick(resq, active, match_fn, J)    # int32[B,W]
        # orphan rescue: a pending short job with no live reservation
        # anywhere may be served by any idle worker
        orphan = short_job & (edge_end <= head[:, None]) & (pending[:, :-1] > 0) & ~has_res
        rescue = torch.amin(torch.where(orphan, j_idx, J), dim=-1)
        job_pick = torch.where(idle, torch.minimum(job_pick, rescue[:, None]), J)
        launch2, task2 = late_bind(job_pick, pending, plist)
        start = t + 3 * cfg.hop  # get-task RPC round trip + launch
        task_finish, worker_finish, worker_task = apply_launch(
            launch2, task2, start, task_finish, worker_finish, worker_task)
        messages = messages + 2 * torch.sum(launch2, dim=-1, dtype=_I32)
        if telemetry:
            n_launch = (torch.sum(launch1, dim=-1, dtype=_I32)
                        + torch.sum(launch2, dim=-1, dtype=_I32))

        # -- 4. central scheduler: queued long window -> free long partition
        if use_central:
            wtask = rt.slice_rows(long_fifo, long_head, CL)        # int32[B,CL]
            wsub = rt.take(submit_pad, torch.clamp(wtask, max=T))
            wsub = torch.where(wtask >= T, float("inf"), wsub)
            launched = rt.window_launched(rt.finish_pad(task_finish), wtask, T)
            queued = ~launched & (wsub <= tt)
            nq = torch.sum(queued, dim=-1, dtype=_I32)             # int32[B]
            # sticky launches punch holes mid-window: sort queued positions
            # ahead of the CL sentinels to recover FIFO order
            fifo = rt.sorted_fifo(queued, CL)
            avail = (worker_finish <= tt) & long_partition          # bool[B,W]
            ranks = match_fn(avail, nq)                              # int32[B,W]
            sel_task = rt.select_from_window(ranks, fifo, wtask, T)
            launch3 = sel_task < T
            task_finish, worker_finish, worker_task = apply_launch(
                launch3, sel_task, start, task_finish, worker_finish, worker_task)
            messages = messages + torch.sum(launch3, dim=-1, dtype=_I32)
            if telemetry:
                n_launch = n_launch + torch.sum(launch3, dim=-1, dtype=_I32)
            # advance the head past the launched prefix
            launched2 = rt.window_launched(rt.finish_pad(task_finish), wtask, T)
            long_head = torch.clamp(long_head + rt.launched_lead(launched2), max=NL)

        upd = dict(
            task_finish=task_finish,
            worker_finish=worker_finish,
            worker_task=worker_task,
            resq=resq,
            probe_head=head,
            res_overflow=s.res_overflow + n_over,
            probe_lag=s.probe_lag + lagged.to(_I32),
            long_head=long_head,
            messages=messages,
            probes=probes,
        )
        if telemetry:
            upd["telemetry"] = dict(launches=n_launch, sss_rejections=n_rej)
        if provenance:
            attempt = probe_attempt(win_j, ins, orphan, tasks.job)
            if use_central:
                # the long tasks of the central scheduler's queued window,
                # written into a pad slot T that is cut off
                attempt = attempt | torch.zeros(
                    (B, T + 1), dtype=torch.bool, device=dev).scatter(
                    -1, torch.where(queued, wtask, T).to(_I64), True)[:, :T]
            wt = torch.clamp(worker_task, max=T).to(_I64)
            aj = torch.clamp(job_pad[wt], max=J - 1) % cfg.num_gms
            upd["provenance"] = dict(attempt=attempt, authority=torch.where(
                long_task[wt], cfg.num_gms, aj).to(_I32))
        return upd

    return rt.compose_step(cfg, tasks, dispatch, faults, telemetry, provenance)


def draw(cfg: SimxConfig, tasks: TaskArrays, generator: torch.Generator) -> dict:
    """Eagle's draws: the short jobs' probe-target table, then the per-job
    re-route rotations, one anywhere (``off1`` in ``[0, W)``) and one into
    the short partition (``off2`` in ``[0, R)``)."""
    *_, kmax = probe_edge_layout(cfg, tasks, short_only=True)
    J = tasks.num_jobs
    return {
        "targets": probe_targets(generator, cfg, tasks, kmax),
        "off1": torch.randint(0, cfg.num_workers, (J,), generator=generator, dtype=_I32),
        "off2": torch.randint(0, cfg.short_reserved, (J,), generator=generator, dtype=_I32),
    }


def _build_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: dict,
    *,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[EagleLayout] = None,
) -> Callable[[EagleState], EagleState]:
    return make_eagle_step(cfg, tasks, draws, match_fn, faults, telemetry, provenance, layout)


def _stream_layout(cfg: SimxConfig, win) -> tuple[EagleLayout, dict]:
    """The window's layout: the probe edges and rotations each job drew at
    admission, and the central FIFO of its long jobs' tasks."""
    n = len(win.jobs)
    offs = np.zeros((2, win.J_cap), np.int32)
    offs[0, :n] = [wj.off1 for wj in win.jobs]
    offs[1, :n] = [wj.off2 for wj in win.jobs]
    off1, off2 = torch.from_numpy(offs).to(win.device)
    long = win.per_task(np.array([wj.est >= cfg.long_threshold for wj in win.jobs], bool), False)
    layout, fifo = eagle_layout(cfg, win.probe_layout(), off1, off2, long, win.device, win.T_cap)
    return layout, {"long_head": fifo}


RULE = rt.register_rule(
    rt.Rule(
        name="eagle",
        init=lambda cfg, tasks, batch=None: init_eagle_state(cfg, tasks, batch),
        build_step=_build_step,
        has_queues=True,
        draw=draw,
        draw_dims={"targets": 2, "off1": 1, "off2": 1},
        stream_layout=_stream_layout,
    )
)
