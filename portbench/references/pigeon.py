"""Plain reference of Pigeon's round-stepped simulation (Wang et al., SoCC
2019, §3; as configured in arXiv:2308.10178 §4.1).

Written from the rule's description, in plain PyTorch, for the points of a
grid that the benchmark checks.  It imports nothing of the program and is
handed only the benchmark's inputs: the configuration and each point's
arrival times (Pigeon draws nothing).  The distribution of tasks over the
groups, each group's FIFOs and each job's priority class are worked out
here again from the configuration's rules.

The workers form ``W // group_size`` fixed groups of ``group_size``
consecutive workers (the last group takes the remainder); the first
``reserved_per_group`` workers of a group run high-priority tasks only.  A
job is high priority when its estimate, its longest task, is below
``long_threshold``.  Jobs go round-robin to ``num_distributors``
distributors (job p to distributor p mod D); distributor d deals the tasks
of its jobs one by one over the groups, starting at group d and going on
where its previous job stopped.  A task never leaves its group.  Each group
keeps one FIFO a class, in task order.

One round of ``dt`` seconds, at round time ``t``, for every group:

1. its free workers: a worker is free once its finish time has passed
   ``t``; they split into free unreserved and free reserved workers;
2. each class's queued tasks: the FIFO's head run of tasks not yet
   launched that have arrived (a group launches at most as many tasks as it
   has workers, so a window of that many entries from the head holds them);
3. weighted fair queueing over the free unreserved workers, one worker at a
   time: a low-priority task is served when one is queued and either
   ``wfq_weight`` high-priority tasks were served since the last low one or
   no high-priority task is left; else a high-priority one.  The count of
   high-priority tasks served since the last low one carries over from
   round to round;
4. high-priority tasks still queued overflow onto the free reserved
   workers;
5. the launch: the served high-priority tasks, in FIFO order, go to the
   lowest-index free unreserved workers, the low-priority ones to the next,
   the overflow to the lowest-index free reserved workers; each FIFO's head
   moves past its launched tasks.

Each arriving task costs one message (distributor to coordinator) and each
launch one (coordinator to worker).  A task launched at ``t`` finishes at
``t + 3 hop + duration`` (client, distributor, coordinator, worker).  Times
are kept in ``time_dtype`` (the configuration's float32; the control
computes them in bfloat16).
"""

from __future__ import annotations

import torch


def groups(cfg: dict, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """``workers int64[NG, S]`` (each group's workers, padded with W) and
    ``reserved bool[NG, S]``."""
    W, size = cfg["num_workers"], cfg["group_size"]
    NG = max(1, W // size)
    last = W - (NG - 1) * size
    S = max(size, last)
    base = torch.arange(NG, device=dev)[:, None] * size
    col = torch.arange(S, device=dev)[None, :]
    sizes = torch.full((NG, 1), size, device=dev)
    sizes[-1] = last
    workers = torch.where(col < sizes, base + col, W)
    reserved = (col < torch.clamp(sizes, max=cfg["reserved_per_group"])) & (col < sizes)
    return workers, reserved


def task_groups(cfg: dict, job_ntasks: torch.Tensor) -> torch.Tensor:
    """int64[T]: the group of every task, tasks in job order.  Job p goes to
    distributor ``d = p mod D``, which deals its tasks from group ``d``
    plus the tasks of its earlier jobs onward."""
    D = cfg["num_distributors"]
    NG = max(1, cfg["num_workers"] // cfg["group_size"])
    n = job_ntasks.to(torch.int64)
    J = n.numel()
    p = torch.arange(J, device=n.device)
    dist = p % D
    # each distributor's tasks dealt before job p
    dealt = torch.zeros((D, J), dtype=torch.int64, device=n.device)
    dealt[dist, p] = n
    before = (torch.cumsum(dealt, 1) - dealt)[dist, p]
    job = torch.repeat_interleave(p, n)
    within = torch.arange(job.numel(), device=n.device) - (torch.cumsum(n, 0) - n)[job]
    return (dist[job] + before[job] + within) % NG


def fifos(mask: torch.Tensor, grp: torch.Tensor, NG: int, S: int) -> torch.Tensor:
    """int64[NG, L + S]: each group's tasks of one class (``mask``) in task
    order, padded with T."""
    T = mask.numel()
    tasks = torch.nonzero(mask).squeeze(-1)
    g = grp[tasks]
    order = torch.sort(g, stable=True).indices
    tasks, g = tasks[order], g[order]
    count = torch.bincount(g, minlength=NG)
    L = int(count.max()) if tasks.numel() else 0
    pos = torch.arange(tasks.numel(), device=mask.device) - (torch.cumsum(count, 0) - count)[g]
    out = torch.full((NG, L + S), T, dtype=torch.int64, device=mask.device)
    out[g, pos] = tasks
    return out


def simulate(cfg: dict, inputs: dict, num_rounds: int, time_dtype=torch.float32) -> dict:
    """Run ``num_rounds`` rounds for K points at once.

    ``inputs``: ``job int64[T]``, ``duration [T]`` and ``job_ntasks [J]``
    (shared), ``submit [K, T]`` and ``job_submit [K, J]``, on one device.
    Returns ``task_finish [K, T]`` (inf where never launched), ``t [K]`` and
    the counters ``messages``, ``probes``, ``inconsistencies``, ``lost``,
    ``res_overflow``, ``probe_lag`` (int64[K])."""
    W, weight = cfg["num_workers"], cfg["wfq_weight"]
    dt, hop = cfg["dt"], cfg["hop"]
    job = inputs["job"].to(torch.int64)
    dev = job.device
    K, T = inputs["submit"].shape
    inf = float("inf")

    workers, reserved = groups(cfg, dev)
    NG, S = workers.shape
    duration = inputs["duration"]
    est = torch.zeros(inputs["job_ntasks"].numel(), dtype=duration.dtype, device=dev)
    est = est.scatter_reduce(0, job, duration, "amax", include_self=False)
    high = est[job] < cfg["long_threshold"]
    grp = task_groups(cfg, inputs["job_ntasks"])
    fifo_h, fifo_l = fifos(high, grp, NG, S), fifos(~high, grp, NG, S)
    col = torch.arange(S, device=dev)

    dur_pad = torch.cat([duration.to(time_dtype), torch.zeros(1, dtype=time_dtype, device=dev)])
    submit = inputs["submit"].to(time_dtype)
    sub_pad = torch.cat([submit, torch.full((K, 1), inf, dtype=time_dtype, device=dev)], 1)
    tf = torch.full((K, T), inf, dtype=time_dtype, device=dev)
    wf = torch.full((K, W + 1), -inf, dtype=time_dtype, device=dev)
    t = torch.zeros(K, dtype=time_dtype, device=dev)
    head_h = torch.zeros((K, NG), dtype=torch.int64, device=dev)
    head_l = torch.zeros((K, NG), dtype=torch.int64, device=dev)
    since_low = torch.zeros((K, NG), dtype=torch.int64, device=dev)
    messages = torch.zeros(K, dtype=torch.int64, device=dev)
    arrived = torch.zeros(K, dtype=torch.int64, device=dev)
    kk = torch.arange(K, device=dev)[:, None, None]

    def queued(fifo, head, tt):
        """The window of S entries from each head, and how many of its
        leading entries have arrived."""
        win = torch.gather(fifo.expand(K, NG, fifo.shape[-1]), -1, head[..., None] + col)
        ready = torch.gather(sub_pad, 1, win.reshape(K, -1)).reshape(K, NG, S) <= tt[..., None]
        return win, torch.cumprod(ready.to(torch.int64), -1).sum(-1)

    for _ in range(num_rounds):
        tt = t[:, None]
        # 1. free workers of each group (the pad worker reads busy)
        free_w = wf <= tt
        free_w[:, W] = False
        free = free_w[kk, workers]                                  # [K, NG, S]
        free_u, free_r = free & ~reserved, free & reserved
        nfu, nfr = free_u.sum(-1), free_r.sum(-1)

        # 2. queued tasks at the heads of the two FIFOs
        win_h, qh = queued(fifo_h, head_h, tt)
        win_l, ql = queued(fifo_l, head_l, tt)

        # 3. weighted fair queueing, one free unreserved worker at a time
        total = torch.minimum(nfu, qh + ql)
        n_low = torch.zeros_like(total)
        if bool((ql > 0).any()):
            n_high = torch.zeros_like(total)
            left_h, left_l = qh.clone(), ql.clone()
            for slot in range(int(total.max())):
                serve = slot < total
                low = serve & (left_l > 0) & ((since_low >= weight) | (left_h == 0))
                hi = (serve & ~low).to(torch.int64)
                n_low += low
                n_high += hi
                left_l -= low.to(torch.int64)
                left_h -= hi
                since_low = torch.where(low, 0, since_low + hi)
        else:
            # no low-priority task queued anywhere: every one served is high
            n_high = total
            since_low = since_low + total
        # 4. high-priority overflow onto the free reserved workers
        n_res = torch.minimum(qh - n_high, nfr)

        # 5. launch onto the lowest-index free workers
        rank_u = torch.cumsum(free_u, -1) - 1
        rank_r = torch.cumsum(free_r, -1) - 1
        nh = n_high[..., None]
        take_h = free_u & (rank_u < nh)
        take_l = free_u & (rank_u >= nh) & (rank_u < nh + n_low[..., None])
        take_r = free_r & (rank_r < n_res[..., None])
        pick_h = torch.gather(win_h, -1, torch.where(take_h, rank_u, 0))
        pick_l = torch.gather(win_l, -1, torch.where(take_l, rank_u - nh, 0))
        pick_r = torch.gather(win_h, -1, torch.where(take_r, nh + rank_r, 0))
        task = torch.where(take_h, pick_h, torch.where(take_l, pick_l,
                                                       torch.where(take_r, pick_r, T)))
        launch = take_h | take_l | take_r
        fin = (t + 3 * hop)[:, None, None] + dur_pad[task]
        ks, gs, ss = launch.nonzero(as_tuple=True)
        tf[ks, task[ks, gs, ss]] = fin[ks, gs, ss]
        wf[ks, workers[gs, ss]] = fin[ks, gs, ss]
        head_h = head_h + n_high + n_res
        head_l = head_l + n_low

        # one message a task on its arrival, one a launch
        now = (submit <= tt).sum(-1)
        messages = messages + (now - arrived) + launch.sum((1, 2))
        arrived = now
        t = t + dt

    z = torch.zeros(K, dtype=torch.int64, device=dev)
    return dict(task_finish=tf, t=t, messages=messages, probes=z, inconsistencies=z.clone(),
                lost=z.clone(), res_overflow=z.clone(), probe_lag=z.clone())
