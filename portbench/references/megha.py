"""Plain reference of Megha's round-stepped simulation (arXiv:2308.10178 §3).

Written from the rule's description, in plain PyTorch, for the points of a
grid that the benchmark checks.  It imports nothing of the program and is
handed only the benchmark's inputs: the configuration, each point's arrival
times and each point's GM priority orders.  Everything the program derives
from them (the per-GM FIFOs, the internal orders, the LM of each worker) is
worked out here again.

One round of ``dt`` seconds, at round time ``t``:

1. Completions: a worker is free once its finish time has passed ``t``; one
   that finished inside the round just ended is handed back to the view of
   the GM that placed it, unless that task was a borrow (the owner's
   heartbeat repairs those).
2. Heartbeat: every ``heartbeat_interval / dt`` rounds each LM's ground
   truth overwrites every GM's view.
3. Internal match: each GM offers the queued tasks of its FIFO window (its
   jobs, round-robin by job id, ``C`` positions from its launched prefix) to
   the workers of its own partitions that its view shows free, in its
   priority order: the r-th such worker gets the r-th queued task.  The LM
   launches the task if the worker is really free; otherwise the proposal is
   an inconsistency.  The GM marks every worker it proposed busy in its view,
   and an LM that rejected a proposal sends the GM a fresh copy of its
   workers' state (a piggyback).  Each (GM, LM) pair that carried proposals
   costs two messages.
4. Borrow match, in a round where some GM has more queued tasks than it
   proposed internally: every GM offers its still-queued tasks over its whole
   priority order; a worker claimed by several GMs goes to the one whose
   ``(g + round) mod G`` is least.  Proposals to a foreign partition count as
   repartitions; rejections are inconsistencies and piggybacks as above.
5. Each GM's launched prefix advances past the launched head of its window.

A task launched at ``t`` starts after three network hops and finishes at
``t + 3 hop + duration``.  Times are kept in ``time_dtype`` (the
configuration's float32; the control computes them in bfloat16).
"""

from __future__ import annotations

import torch


def _launch(state: dict, launch, task, start, dur_pad) -> torch.Tensor:
    """Record launches ``launch bool[K, W]`` of ``task int64[K, W]``:
    worker and task finish at ``start + duration``.  Returns the finish
    times ``[K, W]``."""
    fin = start[:, None] + dur_pad[task]
    state["wf"] = torch.where(launch, fin, state["wf"])
    ks, ws = launch.nonzero(as_tuple=True)
    state["tf"][ks, task[ks, ws]] = fin[ks, ws]
    return fin


def simulate(cfg: dict, inputs: dict, num_rounds: int, time_dtype=torch.float32) -> dict:
    """Run ``num_rounds`` rounds for K points at once.

    ``inputs``: ``job int64[T]`` and ``duration [T]`` (shared),
    ``submit [K, T]``, ``job_submit [K, J]`` and ``orders int64[K, G, W]``
    (each GM's priority order over all workers), on one device.  Returns
    ``task_finish [K, T]`` (inf where never launched), ``t [K]`` and the
    counters ``messages``, ``inconsistencies``, ``repartitions``,
    ``probes``, ``res_overflow``, ``probe_lag``, ``lost`` (int64[K])."""
    W, G, L = cfg["num_workers"], cfg["num_gms"], cfg["num_lms"]
    dt, hop = cfg["dt"], cfg["hop"]
    hb = max(1, int(round(cfg["heartbeat_interval"] / dt)))
    job = inputs["job"].to(torch.int64)
    orders = inputs["orders"].to(torch.int64)
    dev = job.device
    K, T = inputs["submit"].shape
    inf = float("inf")
    per_lm = W // L
    wi = W // G
    w_all = torch.arange(W, device=dev)
    lm_of = w_all // per_lm
    owner = (w_all % per_lm) // (per_lm // G)
    g_idx = torch.arange(G, device=dev)[None, :, None]          # [1, G, 1]

    # each GM's own workers in its priority order: a stable pick of the
    # entries of its order that lie in its partitions
    foreign = (owner[orders] != g_idx).to(torch.int8)
    own = torch.gather(orders, -1, torch.sort(foreign, dim=-1, stable=True).indices)[..., :wi]
    own_lm = lm_of[own]                                         # [K, G, wi]

    # each GM's FIFO: its jobs' tasks (job id mod G) in task order, padded
    # with the no-task id T far enough that a window never runs off it
    task_gm = job % G
    counts = torch.bincount(task_gm, minlength=G)
    tg = int(counts.max())
    C = min(max(W // G, 64), tg)
    fifo = torch.full((G, tg + C), T, dtype=torch.int64, device=dev)
    for g in range(G):
        mine = torch.nonzero(task_gm == g).flatten()
        fifo[g, : mine.numel()] = mine
    fifo = fifo[None].expand(K, G, tg + C)
    c_idx = torch.arange(C, device=dev)

    dur_pad = torch.cat([inputs["duration"].to(time_dtype),
                         torch.zeros(1, dtype=time_dtype, device=dev)])
    sub_pad = torch.cat([inputs["submit"].to(time_dtype),
                         torch.full((K, 1), inf, dtype=time_dtype, device=dev)], dim=1)
    st = dict(
        tf=torch.full((K, T), inf, dtype=time_dtype, device=dev),
        wf=torch.full((K, W), -inf, dtype=time_dtype, device=dev),
    )
    t = torch.zeros(K, dtype=time_dtype, device=dev)
    wgm = torch.zeros((K, W), dtype=torch.int64, device=dev)
    wbor = torch.zeros((K, W), dtype=torch.bool, device=dev)
    view = torch.ones((K, G, W), dtype=torch.bool, device=dev)
    head = torch.zeros((K, G), dtype=torch.int64, device=dev)
    z = torch.zeros(K, dtype=torch.int64, device=dev)
    messages, incons, reparts = z.clone(), z.clone(), z.clone()

    def window(head):
        """Task ids of each GM's window, which of them are queued at ``t``,
        and the id of each GM's r-th queued task."""
        wt = torch.gather(fifo, -1, head[..., None] + c_idx)    # [K, G, C]
        tf_pad = torch.cat([st["tf"], torch.zeros((K, 1), dtype=time_dtype, device=dev)], 1)
        done = (wt == T) | (torch.gather(tf_pad, 1, wt.reshape(K, -1)).reshape(K, G, C) != inf)
        arrived = torch.gather(sub_pad, 1, wt.reshape(K, -1)).reshape(K, G, C) <= t[:, None, None]
        queued = ~done & arrived
        rank = torch.cumsum(queued.to(torch.int64), -1) - 1
        nth = torch.full((K, G, C + 1), T, dtype=torch.int64, device=dev)
        nth.scatter_(-1, torch.where(queued, rank, C), wt)
        return wt, done, queued.sum(-1), nth[..., :C]

    def refresh(view, rejected_gl, truth):
        """GM g re-reads every worker of each LM l that rejected it."""
        return torch.where(rejected_gl[:, :, lm_of], truth[:, None, :], view)

    for rnd in range(num_rounds):
        tt = t[:, None]
        free = st["wf"] <= tt
        comp = free & (st["wf"] > tt - dt)
        view = view | ((wgm[:, None, :] == g_idx) & (comp & ~wbor)[:, None, :])
        messages = messages + comp.sum(-1)
        if rnd % hb == hb - 1:
            view = free[:, None, :].expand(K, G, W).clone()
            messages = messages + G * L
        start = t + 3 * hop

        # internal match
        wt, _, nq, nth = window(head)
        avail = torch.gather(view, -1, own)                       # [K, G, wi]
        arank = torch.cumsum(avail.to(torch.int64), -1) - 1
        prop = avail & (arank < nq[..., None])
        ptask = torch.gather(nth, -1, arank.clamp(0, C - 1))
        truth = free.clone()
        ok = prop & torch.gather(truth, 1, own.reshape(K, -1)).reshape(K, G, wi)
        bad = prop & ~ok
        flat_own = own.reshape(K, -1)
        launch = torch.zeros((K, W), dtype=torch.bool, device=dev).scatter(
            1, flat_own, ok.reshape(K, -1))
        task_w = torch.full((K, W), T, dtype=torch.int64, device=dev).scatter(
            1, flat_own, torch.where(ok, ptask, T).reshape(K, -1))
        _launch(st, launch, task_w, start, dur_pad)
        wgm = torch.where(launch, owner, wgm)
        wbor = wbor & ~launch
        truth = truth & ~launch
        prop_w = torch.zeros((K, W), dtype=torch.bool, device=dev).scatter(
            1, flat_own, prop.reshape(K, -1))
        view = view & ~(prop_w[:, None, :] & (owner[None, None, :] == g_idx))
        incons = incons + bad.sum((1, 2))
        at_lm = own_lm[..., None] == torch.arange(L, device=dev)     # [K, G, wi, L]
        view = refresh(view, (bad[..., None] & at_lm).any(2), truth)
        prop_gl = (prop[..., None] & at_lm).any(2)
        messages = messages + 2 * prop_gl.sum((1, 2))

        # borrow match, for the points whose queues outran their views
        need = (nq > prop.sum(-1)).any(-1)                        # [K]
        if bool(need.any()):
            before = (st["tf"], st["wf"], wgm, wbor, view, truth, incons, reparts, messages)
            _, _, nq2, nth2 = window(head)
            avail = torch.gather(view, -1, orders)                # [K, G, W]
            arank = torch.cumsum(avail.to(torch.int64), -1) - 1
            pick = avail & (arank < nq2[..., None])
            ptask = torch.where(pick, torch.gather(nth2, -1, arank.clamp(0, C - 1)), -1)
            claim = torch.full((K, G, W), -1, dtype=torch.int64, device=dev).scatter(
                -1, orders, ptask)                                # worker coordinates
            proposed = claim >= 0
            reparts = reparts + (proposed & (owner[None, None, :] != g_idx)).sum((1, 2))
            prio = torch.where(proposed, (g_idx + rnd) % G, G).amin(1)    # [K, W]
            claimed = prio < G
            winner = (prio - rnd) % G
            launch = claimed & truth
            task_w = torch.where(
                launch, torch.gather(claim, 1, winner[:, None, :]).squeeze(1), T)
            st["tf"] = st["tf"].clone()
            _launch(st, launch, task_w, start, dur_pad)
            wgm = torch.where(launch, winner, wgm)
            wbor = torch.where(launch, owner != winner, wbor)
            truth = truth & ~launch
            view = view & ~proposed
            won = launch[:, None, :] & (winner[:, None, :] == g_idx)
            invalid = proposed & ~won
            incons = incons + invalid.sum((1, 2))
            view = refresh(view, invalid.reshape(K, G, L, per_lm).any(-1), truth)
            messages = messages + 2 * proposed.reshape(K, G, L, per_lm).any(-1).sum((1, 2))
            after = (st["tf"], st["wf"], wgm, wbor, view, truth, incons, reparts, messages)
            kept = []
            for a, b in zip(after, before):
                sel = need.reshape((K,) + (1,) * (a.dim() - 1))
                kept.append(torch.where(sel, a, b))
            st["tf"], st["wf"], wgm, wbor, view, truth, incons, reparts, messages = kept

        # advance each GM's launched prefix
        wt, done, _, _ = window(head)
        lead = torch.cumprod(done.to(torch.int64), -1).sum(-1)
        head = torch.clamp(head + lead, max=tg)
        t = t + dt

    return dict(task_finish=st["tf"], t=t, messages=messages, inconsistencies=incons,
                repartitions=reparts, probes=z.clone(), res_overflow=z.clone(),
                probe_lag=z.clone(), lost=z.clone())
