"""Sparrow transition rule for the simx round-stepped backend (port of
``repro/simx/sparrow.py``, with the streaming engine's ``ProbeLayout``).

Batch sampling + late binding (§2.2.2).  When a job of n tasks arrives it
probes ``min(d * n, W)`` DISTINCT random workers, leaving a *reservation*
at each.  Each round every idle worker serves the earliest-submitted job
holding a reservation on it that still has pending tasks, and late
binding hands it that job's next pending task.

**Reservation encoding**, as in the reference: capped per-worker queues
``resq int32[W, R]`` of job ids (J = empty), fed from a static probe edge
list (sorted by job id == submit order) through a ``C``-wide window at
the insertion head each round, recycled when their job completes and
re-compacted every round, so each queue stays ascending in job id.  The
head-of-queue pick (the earliest live reservation) is then rank-and-select
with ``n = 1`` per worker row, through the same ``match_fn`` as every
other rule's match: the batched kernel's narrow design at ``[B * W, R]``.

The reference draws the probe targets with ``jax.random`` when it builds
the step; here they are an argument (``targets``, the rule's draws), drawn
from a ``torch.Generator`` by ``probe_targets`` when not fed in, so a run
agrees with the reference's bitwise when given the reference's table and
in distribution otherwise.  Every step is batched over grid points
(``runtime``'s point axis); a single run is B = 1.  Under the streaming
engine (``repro_torch.simx.stream``) the edge list is an argument
(``ProbeLayout``), built on the host from targets drawn per job at
admission, and no target table is drawn.

The reference's ``mode="drop"`` scatters become scatters into a pad slot
that is cut off; only the pad slot ever receives repeated indices, so
every scatter is deterministic on the card.

The whole-queue passes of a round (compaction, the active mask with the
jobs holding a reservation, the head at the pick) go through
``repro_torch.kernels.queues``, and the round's pass over the task axis
(each job's unfinished and pending counts, the list of pending tasks that
late binding reads) through ``repro_torch.kernels.tasks``: one launch each
on the card, the plain versions of ``kernels/ref.py`` on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Optional

import torch

from repro_torch.kernels import queues
from repro_torch.kernels import tasks as task_axis
from repro_torch.simx import runtime as rt
from repro_torch.simx import spans
from repro_torch.simx.faults import FaultSchedule, worker_dead
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.state import (
    SimxConfig,
    SparrowState,
    TaskArrays,
    init_sparrow_state,
    probe_edge_layout,
    spec,
)

_I32, _I64 = torch.int32, torch.int64


@lru_cache(maxsize=None)
def _ones(n: int, device: torch.device) -> torch.Tensor:
    """int32[n] of ones, the pick's per-row ``n``, made once per size."""
    return torch.ones(n, dtype=_I32, device=device)


def _rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a matrix, per point: ``mat [*P, W, R]`` with ``idx
    [*P, K]`` gives ``[*P, K, R]`` (an unbatched ``[W, R]`` takes ``[K]``)."""
    idx = idx.to(_I64)
    if mat.dim() == 2:
        return mat[idx]
    return mat[rt.point_rows(mat.shape[0], idx.dim(), mat.device), idx]


def _rank_within_groups(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(order, rank)``: the stable ascending order of ``keys`` along the
    last axis, and each entry's rank among the entries of equal key that
    come before it (the reference's stable ``argsort`` plus a
    first-occurrence ``searchsorted``)."""
    n = keys.shape[-1]
    order = torch.sort(keys, dim=-1, stable=True).indices
    sk = torch.gather(keys, -1, order)
    first = torch.searchsorted(sk, sk, side="left").to(_I32)
    row = torch.arange(n, dtype=_I32, device=keys.device)
    return order, torch.zeros_like(keys).scatter(-1, order, row - first)


def late_bind(
    job_pick: torch.Tensor, pending: torch.Tensor, plist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Late-binding core shared by the sparrow and eagle rules: worker
    ``w`` serves job ``job_pick[w]`` (J = no claim); the k-th serving
    worker of job j (worker-index order, capped at j's pending count) gets
    j's k-th pending task.  ``pending int32[..., J + 1]`` counts each job's
    pending tasks and ``plist int32[..., T]`` lists them in ascending order
    (``kernels.tasks.task_scan``).  Tasks are contiguous per job in job-id
    order, so job j's pending tasks are the ``pending[j]`` entries of
    ``plist`` after the pending tasks of the jobs before it.  The three
    share their leading (point) axes.  Returns ``(launch bool[..., W], task
    int32[..., W])`` with T meaning none."""
    T, J = plist.shape[-1], pending.shape[-1] - 1
    _, rank = _rank_within_groups(job_pick)
    jp = torch.clamp(job_pick, 0, J - 1)
    per_job = pending[..., :J]
    before = torch.cumsum(per_job, dim=-1, dtype=_I32) - per_job      # int32[..., J]
    serve = (job_pick < J) & (rank < rt.take(per_job, jp))
    pos = rt.take(before, jp) + rank
    task_pick = torch.where(serve, rt.take(plist, torch.clamp(pos, 0, T - 1)), T)
    return serve, task_pick


def probe_targets(
    generator: torch.Generator, cfg: SimxConfig, tasks: TaskArrays, kmax: int
) -> torch.Tensor:
    """int32[J, kmax] (on the CPU) — per-job probe targets: row j's first
    k_j entries are a uniform ordered sample of k_j DISTINCT workers (the
    kmax largest of W uniform scores, in descending order of score).

    The reference draws the scores with ``jax.random``; here they come
    from ``generator`` in the same chunks of ``(1 << 21) // W`` rows (a
    transient ``[chunk, W]`` score buffer of a few MB), so the two agree
    in distribution only.  Parity runs feed the reference's table in."""
    J, W = tasks.num_jobs, cfg.num_workers
    if kmax <= 0 or J == 0:
        return torch.zeros((J, max(kmax, 0)), dtype=_I32)
    chunk = int(max(1, min(J, (1 << 21) // max(W, 1))))
    rows = []
    for _ in range(-(-J // chunk)):
        scores = torch.rand((chunk, W), generator=generator)
        rows.append(torch.topk(scores, kmax, dim=1).indices.to(_I32))
    return torch.cat(rows)[:J]


def probe_mask(targets: torch.Tensor, cfg: SimxConfig, tasks: TaskArrays) -> torch.Tensor:
    """bool[J, W] — the min(d * n_tasks, W) DISTINCT workers each job
    probes: the dense view of a target table ``targets int32[J, kmax]``
    (one scatter), kept for tests; the rules never build it."""
    J, W = tasks.num_jobs, cfg.num_workers
    targets = targets.to(tasks.device)
    kvec = torch.clamp(cfg.probe_ratio * tasks.job_ntasks, max=W)
    kmax = targets.shape[-1]
    keep = torch.arange(kmax, device=tasks.device)[None, :] < kvec[:, None]
    idx = torch.where(keep, targets, W).to(_I64)
    mask = torch.zeros((J, W + 1), dtype=torch.bool, device=tasks.device)
    return mask.scatter(1, idx, True)[:, :W]


def build_probe_edges(
    targets: torch.Tensor, cfg: SimxConfig, tasks: TaskArrays, short_only: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """The flat probe edge list the windowed insertion walks, on
    ``tasks``' device: the target table (``int32[J, kmax]``, or ``[B, J,
    kmax]`` one per point) gathered through ``probe_edge_layout``, the job
    and worker lists padded by the window width C so the head window never
    leaves them at head == P (pad edges carry job J and never arrive).
    Returns ``(edge_job int32[P+C], edge_worker int32[..., P+C],
    edge_end int32[J], P, C)``."""
    J, dev = tasks.num_jobs, tasks.device
    edge_job_np, edge_rank_np, edge_end_np, kmax = probe_edge_layout(
        cfg, tasks, short_only=short_only)
    if tuple(targets.shape[-2:]) != (J, kmax):
        raise ValueError(
            f"probe targets must be [{J}, {kmax}] (or with a point axis), "
            f"got {tuple(targets.shape)}")
    P = int(edge_job_np.size)
    C = cfg.insert_window(P, kmax)
    targets = targets.to(device=dev, dtype=_I32)
    lead = targets.shape[:-2]
    workers = targets[..., torch.from_numpy(edge_job_np).to(dev, _I64),
                      torch.from_numpy(edge_rank_np).to(dev, _I64)]       # [..., P]
    edge_worker = torch.cat([workers, workers.new_zeros(lead + (C,))], -1)
    edge_job = torch.cat([
        torch.from_numpy(edge_job_np).to(dev),
        torch.full((C,), J, dtype=_I32, device=dev),
    ])
    return edge_job, edge_worker, torch.from_numpy(edge_end_np).to(dev), P, C


def probe_window_slice(
    edge_job: torch.Tensor,
    edge_worker: torch.Tensor,
    head: torch.Tensor,
    window: int,
    job_submit_pad: torch.Tensor,
    t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round's view of the edge list: the ``window`` edges at ``head``
    and their ready prefix.  Submit times are sorted by job id, so
    readiness is a prefix: ``lead`` edges insert this round and the head
    advances by it.  Returns ``(win_job, win_worker, lead, ins mask,
    lagged)``, where ``lagged`` means a ready edge was left beyond the
    full window (an exact fit is not lag).  ``head`` and ``t`` are one per
    point (``[B]``, or scalars), ``job_submit_pad`` ``[J + 1]`` or one row
    per point, the edge lists shared or one row per point (lane-stacked
    windows)."""
    J = job_submit_pad.shape[-1] - 1
    win_j = rt.slice_rows(edge_job, head, window)
    win_w = rt.slice_rows(edge_worker, head, window)
    ready = rt.take(job_submit_pad, torch.clamp(win_j, max=J)) <= rt.lift(t, win_j)
    lead = torch.sum(torch.cumprod(ready.to(_I32), dim=-1, dtype=_I32), dim=-1, dtype=_I32)
    ins = torch.arange(window, dtype=_I32, device=win_j.device) < lead[..., None]
    # the first edge past the window: pad edges read as never ready, so a
    # clamped gather is safe at the tail of the list
    nxt = rt.take(edge_job, torch.clamp(head + window, max=edge_job.shape[-1] - 1))
    lagged = (lead == window) & (rt.take(job_submit_pad, torch.clamp(nxt, max=J)) <= t)
    return win_j, win_w, lead, ins, lagged


def insert_probes(
    resq: torch.Tensor,
    fill: torch.Tensor,
    targets: torch.Tensor,
    jobs: torch.Tensor,
    ins: torch.Tensor,
    *,
    buf: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter this round's probe edges into the per-worker queues.

    ``targets``/``jobs`` are the window's edge targets and job ids
    (``[..., C]``), ``ins`` masks the ready prefix, ``fill [..., W]`` the
    live entries of each queue ``resq [..., W, R]``.  A probe landing
    where the same job already holds (or this round gains) a reservation
    merges into one entry; kept edges are appended after each queue's
    live entries, same-round edges aimed at one worker in window order (a
    stable sort by target), and edges whose slot lands past R are dropped
    and counted.  Returns ``(resq, n_overflow)``.  One sentinel catches
    both drops of the reference's scatter (target W, slot >= R): a flat
    index into the queues of every point and one pad slot after them.

    With ``buf`` (``queues.queue_compact``'s buffer, whose first
    ``resq.numel()`` entries are ``resq`` itself and whose last is that pad
    slot) the kept edges are scattered into it in place and ``resq`` comes
    back as that same view: no copy of the queues is made.  Without it the
    queues are copied into such a buffer first."""
    W, R = resq.shape[-2:]
    C = targets.shape[-1]
    lead = targets.shape[:-1]
    tw0 = torch.where(ins, targets, W)
    # same-round duplicates: the stable target sort keeps ascending job
    # order within each target group, so (job, target) repeats are adjacent
    o0 = torch.sort(tw0, dim=-1, stable=True).indices
    st0, sj0 = torch.gather(tw0, -1, o0), torch.gather(jobs, -1, o0)
    dup_s = (st0 == torch.roll(st0, 1, -1)) & (sj0 == torch.roll(sj0, 1, -1))
    dup_s[..., 0] = False
    dup = torch.zeros(lead + (C,), dtype=torch.bool, device=resq.device).scatter(-1, o0, dup_s)
    # earlier-round duplicates: the job already queued on this worker
    held = torch.any(_rows(resq, torch.clamp(tw0, 0, W - 1)) == jobs[..., None], dim=-1)
    keep = ins & ~dup & ~held
    tw = torch.where(keep, targets, W)
    _, rank = _rank_within_groups(tw)
    slot = rt.take(fill, torch.clamp(tw, 0, W - 1)) + rank
    if buf is None:
        buf = torch.cat([resq.reshape(-1), resq.new_zeros(1)])
        resq = buf[:-1].view(resq.shape)
    n = resq.numel()
    # each kept edge has its own (worker, slot) and only the pad slot n
    # takes repeats, so the in-place scatter is deterministic; buf is the
    # round's own (made by this round's compaction, or copied above), so no
    # earlier state sees the write
    point = torch.arange(0, n, W * R, dtype=_I64, device=resq.device).reshape(lead + (1,))
    idx = torch.where((tw < W) & (slot < R), point + tw * R + slot, n)
    buf.scatter_(0, idx.reshape(-1), jobs.expand(lead + (C,)).reshape(-1))
    return resq, torch.sum(keep & (slot >= R), dim=-1, dtype=_I32)


def unfinished_jobs(
    task_finish: torch.Tensor, job: torch.Tensor, t: torch.Tensor, num_jobs: int
) -> torch.Tensor:
    """int32[..., J + 1] — each job's tasks still unfinished at ``t``
    (launched but running included), per point; the last slot is the pad.
    ``job`` is shared or one row per point.  The steps take it, with the
    pending counts and list, from their one ``task_scan`` a round."""
    return task_axis.task_scan(task_finish, None, job, t, num_jobs)[0]


def compact_queues(
    resq: torch.Tensor,
    task_finish: torch.Tensor,
    job: torch.Tensor,
    t: torch.Tensor,
    num_jobs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Recycle the queue slots of completed jobs and re-compact each queue.

    An entry lives while its job still has an unfinished task (launched
    but running included); live entries slide to the front in order, dead
    ones leave, and the tail of each queue is J (one pass,
    ``queues.queue_compact``).  ``job`` is shared or one row per point.
    Returns ``(resq, fill int32[..., W])``.  The steps call
    ``queues.queue_compact`` themselves, to hand its buffer to
    ``insert_probes``."""
    buf, fill = queues.queue_compact(resq, unfinished_jobs(task_finish, job, t, num_jobs))
    return buf[:-1].view(resq.shape), fill


def queue_head_pick(
    resq: torch.Tensor, active: torch.Tensor, match_fn: MatchFn, num_jobs: int
) -> torch.Tensor:
    """int32[..., W] — each worker's head-of-queue job (J = none): the
    first active entry of its compacted, job-id-ordered queue.

    Rank-and-select with ``n = 1`` per worker row, through ``match_fn``
    over the queues flattened to ``[B * W, R]`` rows (the kernel
    wrapper's narrow design: a warp per ``256 // R`` whole rows); the
    entry at each row's rank-0 slot is then read in one pass
    (``queues.queue_head``)."""
    R = resq.shape[-1]
    rows = active.reshape(-1, R)
    ranks = match_fn(rows, _ones(rows.shape[0], rows.device))
    return queues.queue_head(resq, ranks, num_jobs)


def probe_attempt(
    win_j: torch.Tensor, ins: torch.Tensor, orphan: torch.Tensor, job: torch.Tensor
) -> torch.Tensor:
    """bool[B, T] — the tasks whose job a scheduler acted on this round:
    its probes were inserted (``ins`` masks the window's edges ``win_j``)
    or it was orphan-rescued (``orphan`` bool[B, J]).  The reference's
    dropped set over J + 1 slots, the last the pad of the edges left
    out."""
    B, J = orphan.shape
    att_j = torch.zeros((B, J + 1), dtype=torch.bool, device=orphan.device).scatter(
        -1, torch.where(ins, win_j, J).to(_I64), True)[:, :J] | orphan
    return att_j[:, job.to(_I64)]


@dataclass(frozen=True)
class ProbeLayout:
    """The streaming window's probe edge list (the reference's
    ``ProbeLayout``).  Targets are sampled on the host per *global* job id
    at admission, so a job carried across refills keeps its probed
    workers.  Pad edges past the window's real edge count carry ``edge_job
    == J`` (the pad job never arrives, so the ready prefix and the
    probe/message counters stay exact); ``edge_end`` of jobs without probes
    (and of the pad job slot) points past every real edge.  ``window`` is
    the static insertion width C the lists were padded for."""

    edge_job: torch.Tensor = spec("int32[?]")     # P_cap + window edges
    edge_worker: torch.Tensor = spec("int32[?]")  # same length as edge_job
    edge_end: torch.Tensor = spec("int32[J]")
    window: int = 1


def make_sparrow_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    targets: torch.Tensor | None,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[ProbeLayout] = None,
) -> Callable[[SparrowState], SparrowState]:
    """Build the one-round transition function on ``tasks``' device.

    ``targets`` is the probe-target table (``int32[J, kmax]``, or ``[B,
    J, kmax]`` one per point).  Round order: queue recycling/compaction ->
    windowed probe insertion -> late binding (idle workers serve their
    queue heads; an inserted pending job with no reservation anywhere, all
    its probes dropped on full queues, is served by any idle worker: the
    orphan rescue).  The step is batched over grid points.

    With ``faults``, crashed workers lose their in-flight task (it simply
    re-pends: late binding has no head pointer to roll back) and read
    busy until recovery; a pending job whose every queue entry sits on a
    currently dead worker is orphaned and rescued like one whose probes
    were all dropped.  ``faults=None`` builds the fault-free step; an
    empty schedule is bitwise the same run.  The dispatch opens the spans
    ``sparrow.compact``, ``sparrow.insert`` and ``sparrow.bind``
    (``repro_torch.simx.spans``: recorded under the profiler or in a
    session).

    ``telemetry`` adds the per-round ``launches`` counter; ``provenance``
    the extras ``attempt`` (a job's probes were inserted, or it was
    orphan-rescued) and ``authority`` (the job's home scheduler, jobs
    round-robin over ``num_gms`` schedulers).

    ``layout`` (a ``ProbeLayout``, the streaming window's) replaces the edge
    list built from ``targets``, which is then not used (pass None).  It
    does not compose with a fault schedule.  Lane-stacked windows (every
    ``tasks`` field and layout tensor ``[L, ...]``) step L = B lanes."""
    if match_fn is None:
        match_fn = default_match_fn()
    dev = tasks.device
    T, J = tasks.num_tasks, tasks.num_jobs
    if layout is None:
        edge_job, edge_worker, edge_end, _, C = build_probe_edges(targets, cfg, tasks)
    else:
        if faults is not None:
            raise NotImplementedError(
                "streaming layout does not compose with fault schedules"
            )
        edge_job, edge_worker, edge_end = (
            layout.edge_job.to(dev), layout.edge_worker.to(dev), layout.edge_end.to(dev))
        C = layout.window
    # one row of arrival times per grid point (or one shared row)
    submit = tasks.submit.reshape(-1, T)
    job_submit = tasks.job_submit.reshape(-1, J)
    job_submit_pad = torch.cat([job_submit, job_submit.new_full((job_submit.shape[0], 1),
                                                                float("inf"))], -1)
    j_idx = torch.arange(J, dtype=_I32, device=dev)
    dur_pad = rt.pad_last(tasks.duration, 0.0)

    def dispatch(s, t, task_finish0, worker_finish0, idle, comp, lost_w):
        # completions are implicit (a worker is idle iff worker_finish <=
        # t) and task_finish was recorded at launch; a crash-lost task
        # simply re-pends, so ``lost_w`` goes unused
        del comp, lost_w

        with spans.span("sparrow.compact"):
            # -- 0. one pass over the tasks: per-job unfinished and pending
            # counts, the pending list; then recycle completed jobs' slots
            # and compact the queues
            unfinished, pending, plist = task_axis.task_scan(task_finish0, submit, tasks.job, t, J)
            buf, fill = queues.queue_compact(s.resq, unfinished)

        with spans.span("sparrow.insert"):
            # -- 1. windowed probe insertion (edge list is in arrival order)
            win_j, win_w, lead, ins, lagged = probe_window_slice(
                edge_job, edge_worker, s.probe_head, C, job_submit_pad, t)
            resq, n_over = insert_probes(buf[:-1].view(s.resq.shape), fill, win_w, win_j,
                                         ins, buf=buf)
            head = s.probe_head + lead
            # every probe RPC counts (and costs a message), kept or dropped
            messages = s.messages + lead

        with spans.span("sparrow.bind"):
            # -- 2. late binding: idle workers serve their queue heads ------
            # orphan rescue: an inserted pending job with no live reservation
            # anywhere (all probes dropped on full queues, or, under faults,
            # every probed worker currently dead) may be served by any idle
            # worker (dead workers never serve: worker_finish holds recovery)
            dead = worker_dead(faults, t) if faults is not None else None
            active, has_res = queues.queue_scan(resq, pending, dead=dead)
            job_pick = queue_head_pick(resq, active, match_fn, J)              # int32[B,W]
            orphan = (edge_end <= head[:, None]) & (pending[:, :-1] > 0) & ~has_res
            rescue = torch.amin(torch.where(orphan, j_idx, J), dim=-1)
            job_pick = torch.minimum(job_pick, rescue[:, None])
            launch, task_pick = late_bind(torch.where(idle, job_pick, J), pending, plist)
            # client->scheduler hop + worker->scheduler get-task RPC round trip
            task_finish, worker_finish, worker_task = rt.apply_launch(
                launch, task_pick, t + 3 * cfg.hop, dur_pad,
                task_finish0, worker_finish0, s.worker_task, T)
            messages = messages + 2 * torch.sum(launch, dim=-1, dtype=_I32)  # RPC + reply

        upd = dict(
            task_finish=task_finish,
            worker_finish=worker_finish,
            worker_task=worker_task,
            resq=resq,
            probe_head=head,
            res_overflow=s.res_overflow + n_over,
            probe_lag=s.probe_lag + lagged.to(_I32),
            probes=s.probes + lead,
            messages=messages,
        )
        if telemetry:
            upd["telemetry"] = dict(launches=torch.sum(launch, dim=-1, dtype=_I32))
        if provenance:
            upd["provenance"] = dict(
                attempt=probe_attempt(win_j, ins, orphan, tasks.job),
                authority=(tasks.job[torch.clamp(worker_task, max=T - 1).to(_I64)]
                           % cfg.num_gms).to(_I32))
        return upd

    return rt.compose_step(cfg, tasks, dispatch, faults, telemetry, provenance)


def draw(cfg: SimxConfig, tasks: TaskArrays, generator: torch.Generator) -> dict:
    """Sparrow's draws: the probe-target table (``probe_targets``)."""
    *_, kmax = probe_edge_layout(cfg, tasks)
    return {"targets": probe_targets(generator, cfg, tasks, kmax)}


def _build_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: dict,
    *,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[ProbeLayout] = None,
) -> Callable[[SparrowState], SparrowState]:
    return make_sparrow_step(cfg, tasks, draws.get("targets"), match_fn, faults,
                             telemetry, provenance, layout)


RULE = rt.register_rule(
    rt.Rule(
        name="sparrow",
        init=lambda cfg, tasks, batch=None: init_sparrow_state(cfg, tasks, batch),
        build_step=_build_step,
        has_queues=True,
        draw=draw,
        draw_dims={"targets": 2},
        # the window's edge list, from the targets each job drew at admission
        stream_layout=lambda cfg, win: (win.probe_layout(), {}),
    )
)
