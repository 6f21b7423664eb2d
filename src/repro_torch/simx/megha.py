"""Megha transition rule for the simx round-stepped backend (port of
``repro/simx/megha.py``, with the streaming engine's ``MeghaLayout``).

One round advances the whole datacenter by ``cfg.dt`` simulated seconds:

  1. **complete** — workers whose task finished inside the round window just
     ended free up; the scheduling GM's view regains NON-borrowed workers
     immediately (borrowed ones wait for the owner's heartbeat, §3.4).
  2. **heartbeat** — every ``heartbeat_rounds`` rounds all LM snapshots
     overwrite every GM view (§3.1).
  3. **internal match** — each GM ranks the free workers of its own
     partitions (in its shuffled priority order, §3.3) with the
     rank-and-select primitive and proposes its queued tasks (FIFO) onto
     them; the LM ground truth verifies each mapping.
  4. **borrow match** (only when some GM's queue outruns its internal free
     view) — the §3.2 repartition pass over each GM's whole priority
     order, simultaneous claims arbitrated by a per-round rotating GM
     priority.  Failed proposals in either phase are inconsistencies: the
     proposing GM keeps those workers marked busy and gets a piggybacked
     fresh snapshot of every LM that rejected it (§3.4.1).

Under a fault schedule (``repro_torch.simx.faults``) the round gains the
§3.5 masked transitions: crashed workers lose their in-flight task (the
GM's FIFO head rolls back) and read busy until recovery, while stale views
keep proposing onto them until heartbeats or piggybacks repair them; down
GMs stop matching and live GMs adopt their queues round-robin, matching
against the adopter's own view; a recovering GM's view resets from LM
ground truth; ``hb_extra_rounds`` stretches the heartbeat period.

The reference enters the borrow pass through ``lax.cond``; here it is a
Python ``if`` on a device scalar, one host sync per round.  The step runs
a batch of grid points at once (see ``make_megha_step``); a single run is
a batch of one.

The step reads its per-GM FIFOs from a ``MeghaLayout``, which
``megha_layout`` builds for a fixed trace when the step is built and for
the streaming engine's window (``repro_torch.simx.stream``) at every
refill, which passes it in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.simx import runtime as rt
from repro_torch.simx import spans
from repro_torch.simx.faults import (
    FaultSchedule,
    gm_adoption,
    gm_down_mask,
    gm_recovered_now,
)
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.state import (
    FifoRows,
    MeghaState,
    SimxConfig,
    TaskArrays,
    fifo_rows,
    init_megha_state,
    spec,
)


def gm_orders(generator: torch.Generator, cfg: SimxConfig) -> torch.Tensor:
    """int32[G, W] (on the CPU) per-GM priority permutations: own
    partitions (shuffled) first, then external partitions (shuffled).

    The reference draws these with ``jax.random``; the port draws them
    with ``torch.randperm`` from ``generator``, so the two agree in
    distribution only.  Parity runs pass the reference's orders in."""
    cfg.validate_megha_grid()
    w = np.arange(cfg.num_workers)
    part_gm = (w % cfg.workers_per_lm) // cfg.partition_size
    rows = []
    for g in range(cfg.num_gms):
        internal = torch.from_numpy(w[part_gm == g].astype(np.int32))
        external = torch.from_numpy(w[part_gm != g].astype(np.int32))
        rows.append(torch.cat([
            internal[torch.randperm(internal.numel(), generator=generator)],
            external[torch.randperm(external.numel(), generator=generator)],
        ]))
    return torch.stack(rows)


@dataclass(frozen=True)
class MeghaLayout:
    """Megha's per-GM task layout (the reference's ``MeghaLayout``), built
    by ``megha_layout`` for a fixed trace and for the streaming window
    alike.  ``gm_tasks`` rows list each GM's task ids in submit order (GM =
    job id % G; the stream's global job id, so a carried job keeps its GM
    across refills), padded with the sentinel ``T``; ``gm_len`` clamps
    each row's head.  ``window`` is the static match window C the rows
    were padded for."""

    gm_tasks: torch.Tensor = spec("int32[G, ?]")  # rows: capacity + window
    gm_len: torch.Tensor = spec("int32[G]")
    window: int = 1


def megha_layout(cfg: SimxConfig, task_job: np.ndarray, device,
                 capacity: int | None = None) -> tuple[MeghaLayout, FifoRows]:
    """The per-GM FIFOs of a task set (``task_job`` int[T]: each task's job
    id, -1 for none; T the sentinel) and their host rows.  Rows hold
    ``capacity`` tasks plus the window C = min(max(W / G, 64), capacity).
    The stream passes its task slots, and ``gm_len`` holds the real row
    lengths; a fixed trace passes None, and the longest row is both the
    capacity and every row's ``gm_len``: the reference's head clamp, which
    runs a shorter row's head on through its sentinel pads."""
    G = cfg.num_gms
    task_gm = np.where(task_job >= 0, task_job % G, -1)
    cap = (max(1, int(np.bincount(task_gm[task_gm >= 0], minlength=G).max()))
           if capacity is None else capacity)
    C = min(max(cfg.num_workers // G, 64), cap)
    fifo = fifo_rows(task_gm, G, cap + C, task_job.size)
    gm_len = np.full(G, cap, np.int32) if capacity is None else fifo.lens
    return MeghaLayout(torch.from_numpy(fifo.rows).to(device),
                       torch.from_numpy(gm_len).to(device), C), fifo


def make_megha_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    orders: torch.Tensor,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[MeghaLayout] = None,
) -> Callable[[MeghaState], MeghaState]:
    """Build the one-round transition function on ``tasks``' device, under
    the fault schedule ``faults`` (leaves shared or one per point) if one
    is given; ``faults=None`` builds the fault-free step, and an empty
    schedule is bitwise the same run.

    Layout, as in the reference: tasks live in a compact per-GM layout
    ``gm_tasks[G, Tg]`` (jobs round-robin over GMs, padded with the
    sentinel T); each GM examines a ``C``-wide FIFO window from its
    launched-prefix ``head``, ``C = max(W / G, 64)`` (capped at the
    longest GM queue), so the G GMs together can fill the whole DC in one
    round; the common case runs on [G, W/G] internal-partition arrays and
    the [G, W] borrow pass runs only on rounds that need it; GM <-> worker
    coordinates convert through precomputed inverse permutations
    (gathers, not scatters).

    The step is batched over grid points (``runtime``'s point axis):
    ``orders`` is ``int32[G, W]`` (shared by every point) or ``[B, G, W]``
    (one set per point), and ``tasks`` may carry per-point arrival times.
    Under the reference's ``vmap`` its ``lax.cond`` into the borrow pass
    is a select; here the pass runs when any point needs it (one host
    read per round for all points) and each point keeps its results only
    if it needed the pass itself.

    The returned step carries ``step.borrow_rounds``, the number of rounds
    that entered the borrow pass, and ``step.point_borrow_rounds``
    (``int32[B]``, None before the first borrow), the rounds each point
    borrowed in.  The dispatch opens the spans ``megha.heartbeat``
    (rollback, completions, heartbeat), ``megha.internal_match``,
    ``megha.borrow`` (with ``megha.borrow_check`` around the host read)
    and ``megha.head``, and counts ``megha.borrow_rounds`` and, per point,
    ``megha.borrow_points`` beside the two counters above
    (``repro_torch.simx.spans``: recorded under the profiler or in a
    session).

    Under faults the heartbeat period ``hb + hb_extra_rounds`` and the
    adoption map are per point; both matches read the adopter's view
    (``view[adopt]``, a gather along G per point), and a rejected proposal
    refreshes the adopter's view (a max-scatter along G, whose order does
    not matter).

    ``telemetry`` adds the per-round ``launches`` and piggybacked [GM, LM]
    ``view_repairs`` counters; ``provenance`` the extras ``attempt``
    (every queued task of a GM window), ``stale`` (invalid proposals per
    task) and ``authority`` (the launching GM).  The borrow pass's share of
    each reaches only the points that needed the pass, through the same
    select as the state.

    ``layout`` (a ``MeghaLayout``, the streaming window's) is the per-GM
    layout the step reads; without one the step builds the fixed trace's
    with ``megha_layout``.  A given layout reads nothing of the trace to
    the host, and does not compose with a fault schedule.  Lane-stacked
    windows (``tasks`` with every field ``[L, ...]``, a layout of ``[L,
    ...]`` tensors; the sharded steady state's) step L = B lanes, one
    window each."""
    if match_fn is None:
        match_fn = default_match_fn()
    if layout is not None and faults is not None:
        raise NotImplementedError(
            "streaming layout does not compose with fault schedules"
        )
    cfg.validate_megha_grid()
    dev = tasks.device
    G, L, W = cfg.num_gms, cfg.num_lms, cfg.num_workers
    wpl = cfg.workers_per_lm
    wi = W // G                                        # internal workers per GM
    T = tasks.num_tasks
    hb = cfg.heartbeat_rounds
    part_gm = cfg.partition_gms(dev)                   # int32[W]
    g_col = torch.arange(G, dtype=torch.int32, device=dev)[None, :, None]  # [1,G,1]
    l_row = torch.arange(L, dtype=torch.int32, device=dev)[None, None, None, :]
    w_row = torch.arange(W, dtype=torch.int64, device=dev)
    orders = orders.to(device=dev, dtype=torch.int64)
    if tuple(orders.shape[-2:]) != (G, W) or orders.dim() not in (2, 3):
        raise ValueError(f"orders must be [{G}, {W}] or [B, {G}, {W}], got {tuple(orders.shape)}")
    orders = orders.reshape(-1, G, W)                  # [Bo, G, W], Bo = 1 or B
    inv_orders = torch.argsort(orders, dim=-1)         # [Bo, G, W]
    int_ord = orders[..., :wi].contiguous()            # [Bo, G, wi] own workers
    # rows of int_ord partition [0, W): flattening gives a W-permutation
    inv_int = torch.argsort(int_ord.reshape(-1, G * wi), dim=-1)  # [Bo, W] -> (g, i)
    lm_int = (int_ord // wpl).to(torch.int32)          # int32[Bo, G, wi]

    if not layout:
        # a fixed trace: jobs round-robin over the GMs
        task_job = tasks.job.cpu().numpy()
        layout, fifo = megha_layout(cfg, task_job, dev)
    # int32[1, G, Tg+C], or [L, G, T_cap+C] for lane-stacked windows
    gm_tasks = layout.gm_tasks.to(dev)
    if gm_tasks.dim() == 2:
        gm_tasks = gm_tasks[None]
    C = layout.window
    gm_len = layout.gm_len.to(dev)                     # int32[G] or [L, G]
    if faults is not None:
        # task -> (gm row, FIFO position) for crash-loss head rollback;
        # the T pad routes to the pad row G, which is cut off
        task_gm_pad = torch.from_numpy(
            np.append(task_job % G, G).astype(np.int64)).to(dev)
        task_pos_pad = torch.from_numpy(np.append(fifo.pos, np.int32(0))).to(dev)
    # task submit times in the padded compact layout (sentinel -> inf),
    # one row per point of a grid (Bt = 1 when the arrivals are shared)
    submit = tasks.submit.reshape(-1, T)                      # [Bt, T]
    submit_pad = torch.cat([submit, submit.new_full((submit.shape[0], 1), float("inf"))], -1)
    submit_c = rt.take(submit_pad, gm_tasks)                  # [Bt, G, Tg+C]
    dur_pad = rt.pad_last(tasks.duration, 0.0)

    def adopted(view, adopt):
        """Each GM row's view as its adopter sees it (``view[adopt]`` per
        point); the view itself without a fault schedule."""
        if adopt is None:
            return view
        return torch.gather(view, 1, adopt.to(torch.int64)[..., None].expand(view.shape))

    def launch_updates(start, launch_w, task_w, gm_w, task_finish, worker_finish,
                       worker_task, worker_gm, worker_borrowed):
        """Apply one phase's launches ([B, W] masks): the shared launch
        bookkeeping plus megha's owner/borrow tracking."""
        task_finish, worker_finish, worker_task = rt.apply_launch(
            launch_w, task_w, start, dur_pad,
            task_finish, worker_finish, worker_task, T,
        )
        worker_gm = torch.where(launch_w, gm_w, worker_gm)
        worker_borrowed = torch.where(launch_w, part_gm != gm_w, worker_borrowed)
        return task_finish, worker_finish, worker_task, worker_gm, worker_borrowed

    def piggyback(view, truth, invalid_gl, adopt=None):
        """Refresh GM g's view of every LM that rejected one of its
        proposals with that LM's fresh ground truth (§3.4.1).  Under GM
        adoption the refresh lands on the adopter's view (it made the
        proposal): a max over the rows each GM adopted, carried as uint8
        (two down GMs may share an adopter)."""
        if adopt is not None:
            B_ = invalid_gl.shape[0]
            invalid_gl = torch.zeros((B_, G, L), dtype=torch.uint8, device=dev).scatter_reduce(
                1, adopt.to(torch.int64)[..., None].expand(B_, G, L),
                invalid_gl.to(torch.uint8), "amax", include_self=True).to(torch.bool)
        refresh = torch.repeat_interleave(invalid_gl, wpl, dim=-1)  # bool[B,G,W]
        return torch.where(refresh, truth.unsqueeze(1), view)

    def dispatch(s, t, task_finish0, worker_finish0, truth, comp, lost_w):
        with spans.span("megha.heartbeat"):
            head0 = s.head
            B = head0.shape[0]
            # -- 0. crash-loss rollback (the fault stage ran in the runtime)
            if faults is not None:
                # re-enqueue lost tasks: roll each GM's FIFO head back to the
                # earliest lost position (several lost tasks of one GM: a min)
                lt0 = torch.where(lost_w, s.worker_task, T).to(torch.int64)
                head0 = rt.rollback_heads(head0, task_gm_pad[lt0], task_pos_pad[lt0])
            t3 = t.reshape(B, 1, 1)
            # launch start = round time + client->GM + GM->LM + LM->worker hops
            start = t.reshape(B, 1) + 3 * cfg.hop

            # -- 1. completions (truth/comp = the runtime's completion stage) ---
            regain = (s.worker_gm.unsqueeze(1) == g_col) & (comp & ~s.worker_borrowed).unsqueeze(1)
            view = s.view | regain
            messages = s.messages + torch.sum(comp, dim=-1, dtype=torch.int32)  # LM -> GM

            # -- 2. heartbeat (+ GM down windows / recovery resets) ---------
            period, hb_messages, adopt = hb, G * L, None
            if faults is not None:
                period = hb + faults.hb_extra_rounds                  # delay perturbation
                adopt, row_active, n_live = gm_adoption(gm_down_mask(faults, t), s.rnd)
                hb_messages = n_live * L                              # live GMs only
            do_hb = (s.rnd % period) == (period - 1)                  # bool[B]
            view = torch.where(do_hb.reshape(B, 1, 1), truth.unsqueeze(1), view)
            messages = messages + do_hb.to(torch.int32) * hb_messages
            if faults is not None:
                # §3.5 recovery: a returning GM rebuilds its view from LM truth
                rec = gm_recovered_now(faults, t, cfg.dt)             # bool[B,G]
                view = torch.where(rec[..., None], truth.unsqueeze(1), view)
                messages = messages + L * torch.sum(rec, dim=-1, dtype=torch.int32)

        with spans.span("megha.internal_match"):
            # -- 3. internal match (FIFO windows, [B, G, W/G] arrays) -------
            wtask = rt.slice_rows(gm_tasks, head0, C)                 # int32[B,G,C]
            wsubmit = rt.slice_rows(submit_c, head0, C)               # float32[B,G,C]
            fpad = rt.finish_pad(task_finish0)
            launched_w = rt.window_launched(fpad, wtask, T)           # bool[B,G,C]
            queued_w = ~launched_w & (wsubmit <= t3)                  # bool[B,G,C]
            if faults is not None:
                queued_w = queued_w & row_active[..., None]  # frozen when no GM live
            nq = torch.sum(queued_w, dim=-1, dtype=torch.int32)       # int32[B,G]
            fifo = rt.sorted_fifo(queued_w, C)                        # int32[B,G,C]
            avail_int = rt.take(adopted(view, adopt), int_ord)        # bool[B,G,wi]
            ranks_i = match_fn(avail_int.reshape(B * G, wi), nq.reshape(B * G))
            ranks_i = ranks_i.reshape(B, G, wi)                       # int32[B,G,wi]
            sel_pos = torch.gather(fifo, -1, ranks_i.clamp(0, C - 1).to(torch.int64))
            sel_task_i = torch.where(
                ranks_i >= 0,
                torch.gather(wtask, -1, sel_pos.clamp(0, C - 1).to(torch.int64)),
                -1,
            )                                                         # int32[B,G,wi]
            proposed_i = sel_task_i >= 0
            truth_int = rt.take(truth, int_ord)                       # bool[B,G,wi]
            launch_i = proposed_i & truth_int
            invalid_i = proposed_i & ~truth_int
            # flat (g, i) -> worker coordinates via the static inverse perm
            launch_w = rt.take(launch_i.reshape(B, G * wi), inv_int)  # bool[B,W]
            task_w = torch.where(launch_w, rt.take(sel_task_i.reshape(B, G * wi), inv_int), T)
            (task_finish, worker_finish, worker_task, worker_gm,
             worker_borrowed) = launch_updates(
                start, launch_w, task_w, part_gm,
                task_finish0, worker_finish0, s.worker_task,
                s.worker_gm, s.worker_borrowed,
            )
            truth = truth & ~launch_w
            # the proposing GM marks every proposed internal worker busy in its
            # own view (popped from the free pool when the batch was built)
            proposed_own = rt.take(proposed_i.reshape(B, G * wi), inv_int)  # bool[B,W]
            view = view & ~(proposed_own.unsqueeze(1) & (part_gm == g_col))
            inconsistencies = s.inconsistencies + torch.sum(
                invalid_i, dim=(1, 2), dtype=torch.int32)
            inval_gl = (invalid_i[..., None] & (lm_int[..., None] == l_row)).any(dim=-2)
            view = piggyback(view, truth, inval_gl, adopt)
            batch_gl = (proposed_i[..., None] & (lm_int[..., None] == l_row)).any(dim=-2)
            messages = messages + 2 * torch.sum(batch_gl, dim=(1, 2), dtype=torch.int32)
            repartitions = s.repartitions
            extra = ()
            if telemetry:
                # launches + piggybacked [GM, LM] view repairs (§3.4.1)
                extra += (torch.sum(launch_w, dim=-1, dtype=torch.int32),
                          torch.sum(inval_gl, dim=(1, 2), dtype=torch.int32))
            if provenance:
                # attempt = every queued task of a GM window (ranked this
                # round); stale = per-task invalid proposals (§3.4), each
                # written into a pad slot T that is cut off
                att = torch.zeros((B, T + 1), dtype=torch.bool, device=dev).scatter(
                    -1, torch.where(queued_w, wtask, T).reshape(B, -1).to(torch.int64), True)
                prov_attempt = att[:, :T]
                stale_pad = torch.zeros((B, T + 1), dtype=torch.int32, device=dev).scatter_add(
                    -1, torch.where(invalid_i, sel_task_i, T).reshape(B, -1).to(torch.int64),
                    torch.ones((B, G * wi), dtype=torch.int32, device=dev))
                extra += (stale_pad,)

        with spans.span("megha.borrow"):
            # -- 4. borrow match (full [B, G, W] pass, only when queues outrun
            #       the views): the deliberate host read, skipping the pass ---
            placed_i = torch.sum(proposed_i, dim=-1, dtype=torch.int32)
            need_b = torch.any(nq > placed_i, dim=-1)                 # bool[B]
            with spans.span("megha.borrow_check", read=True):
                need = bool(torch.any(need_b))  # simxlint: disable=TH001 (reference's lax.cond)
            if need:
                step.borrow_rounds += 1
                spans.count("megha.borrow_rounds", 1)
                if step.point_borrow_rounds is None:
                    step.point_borrow_rounds = torch.zeros(B, dtype=torch.int32, device=dev)
                step.point_borrow_rounds += need_b
                spans.count("megha.borrow_points", need_b)
                # kept only when points may disagree: at B = 1 holding them
                # would keep a second task_finish alive through the pass
                old = (task_finish, worker_finish, worker_task, worker_gm, worker_borrowed,
                       view, inconsistencies, repartitions, messages) + extra if B > 1 else None
                fpad2 = rt.finish_pad(task_finish)
                launched2 = rt.window_launched(fpad2, wtask, T)
                queued2 = ~launched2 & (wsubmit <= t3)
                if faults is not None:
                    queued2 = queued2 & row_active[..., None]
                nq2 = torch.sum(queued2, dim=-1, dtype=torch.int32)
                fifo2 = rt.sorted_fifo(queued2, C)
                avail_ord = rt.take(adopted(view, adopt), orders)       # bool[B,G,W]
                ranks = match_fn(avail_ord.reshape(B * G, W), nq2.reshape(B * G))
                ranks = ranks.reshape(B, G, W)                          # int32[B,G,W]
                sel_pos2 = torch.gather(fifo2, -1, ranks.clamp(0, C - 1).to(torch.int64))
                sel_task = torch.where(
                    ranks >= 0,
                    torch.gather(wtask, -1, sel_pos2.clamp(0, C - 1).to(torch.int64)),
                    -1,
                )
                # ordered positions -> worker coordinates (inverse gather)
                prop = rt.take(sel_task, inv_orders)                    # int32[B,G,W]
                proposed = prop >= 0
                repartitions = repartitions + torch.sum(
                    proposed & (part_gm != g_col), dim=(1, 2), dtype=torch.int32
                )
                # simultaneous claims: per-round rotating GM priority, one
                # min-reduction over (priority, gm) packed into a single int
                pri = (g_col + s.rnd.reshape(B, 1, 1)) % G              # int32[B,G,1]
                enc = torch.where(proposed, (pri * G).expand(B, G, W) + g_col, G * G)
                win_enc = torch.amin(enc, dim=1)                        # int32[B,W]
                any_prop = win_enc < G * G
                win_g = torch.where(any_prop, win_enc % G, 0)
                launch = any_prop & truth                               # bool[B,W]
                win_task = torch.where(
                    launch, prop[rt.point_rows(B, 2, dev), win_g.to(torch.int64), w_row], T
                )
                (task_finish, worker_finish, worker_task, worker_gm,
                 worker_borrowed) = launch_updates(
                    start, launch, win_task, win_g,
                    task_finish, worker_finish, worker_task,
                    worker_gm, worker_borrowed,
                )
                truth = truth & ~launch
                view = view & ~proposed
                launched_by_g = launch.unsqueeze(1) & (g_col == win_g.unsqueeze(1))
                invalid = proposed & ~launched_by_g                     # bool[B,G,W]
                inconsistencies = inconsistencies + torch.sum(
                    invalid, dim=(1, 2), dtype=torch.int32)
                inval2_gl = invalid.reshape(B, G, L, wpl).any(dim=-1)
                view = piggyback(view, truth, inval2_gl, adopt)
                batch2 = proposed.reshape(B, G, L, wpl).any(dim=-1)
                messages = messages + 2 * torch.sum(batch2, dim=(1, 2), dtype=torch.int32)
                if telemetry:
                    extra = (extra[0] + torch.sum(launch, dim=-1, dtype=torch.int32),
                             extra[1] + torch.sum(inval2_gl, dim=(1, 2), dtype=torch.int32)
                             ) + extra[2:]
                if provenance:
                    stale_pad = extra[-1].scatter_add(
                        -1, torch.where(invalid, prop, T).reshape(B, -1).to(torch.int64),
                        torch.ones((B, G * W), dtype=torch.int32, device=dev))
                    extra = extra[:-1] + (stale_pad,)
                if B > 1:
                    # a point that did not need the pass still proposed in it
                    # (its inconsistent proposals count): keep its old values
                    new = (task_finish, worker_finish, worker_task, worker_gm,
                           worker_borrowed, view, inconsistencies, repartitions,
                           messages) + extra
                    (task_finish, worker_finish, worker_task, worker_gm,
                     worker_borrowed, view, inconsistencies, repartitions, messages,
                     *extra) = (torch.where(rt.lift(need_b, a), a, b) for a, b in zip(new, old))

        with spans.span("megha.head"):
            # -- 5. advance each GM's FIFO head past its launched prefix ----
            fpad3 = rt.finish_pad(task_finish)
            launched3 = rt.window_launched(fpad3, wtask, T)            # bool[B,G,C]
            head = torch.clamp(head0 + rt.launched_lead(launched3), max=gm_len)

        upd = dict(
            task_finish=task_finish,
            head=head,
            worker_finish=worker_finish,
            worker_task=worker_task,
            worker_gm=worker_gm,
            worker_borrowed=worker_borrowed,
            view=view,
            inconsistencies=inconsistencies,
            repartitions=repartitions,
            messages=messages,
        )
        if telemetry:
            upd["telemetry"] = dict(launches=extra[0], view_repairs=extra[1])
        if provenance:
            upd["provenance"] = dict(attempt=prov_attempt, stale=extra[-1][:, :T],
                                     authority=worker_gm)
        return upd

    step = rt.compose_step(cfg, tasks, dispatch, faults, telemetry, provenance)
    step.borrow_rounds = 0
    step.point_borrow_rounds = None
    return step


def _build_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: dict,
    *,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry: bool = False,
    provenance: bool = False,
    layout: Optional[MeghaLayout] = None,
) -> Callable[[MeghaState], MeghaState]:
    return make_megha_step(cfg, tasks, draws["orders"], match_fn, faults, telemetry, provenance,
                           layout)


def _stream_layout(cfg: SimxConfig, win) -> tuple[MeghaLayout, dict]:
    """The window's per-GM FIFOs, by the global job id of each task."""
    gid = win.per_task(np.array([wj.gid for wj in win.jobs], np.int64), -1)
    layout, fifo = megha_layout(cfg, gid, win.device, capacity=win.T_cap)
    return layout, {"head": fifo}


RULE = rt.register_rule(
    rt.Rule(
        name="megha",
        init=lambda cfg, tasks, batch=None: init_megha_state(
            cfg, tasks.num_tasks, tasks.device, batch),
        build_step=_build_step,
        needs_grid=True,
        draw=lambda cfg, tasks, generator: {"orders": gm_orders(generator, cfg)},
        draw_dims={"orders": 2},
        stream_layout=_stream_layout,
    )
)
