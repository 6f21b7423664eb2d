"""Plain reference of Sparrow's round-stepped simulation (Ousterhout et al.,
SOSP 2013, §3; as configured in arXiv:2308.10178 §4.1).

Written from the rule's description, in plain PyTorch, for the points of a
grid that the benchmark checks.  It imports nothing of the program and is
handed only the benchmark's inputs: the configuration, each point's arrival
times and each point's probe targets.  The probe list, the queue sizes and
the insertion window are worked out here again from the configuration's
rules.

Batch sampling with late binding.  A job of n tasks probes ``k = min(d n,
W)`` distinct workers, the first k of its target row; every probe leaves a
reservation in its worker's queue of ``R`` slots.  All probes of the trace
form one list in job order, walked ``C`` probes a round from an insertion
head.  One round of ``dt`` seconds, at round time ``t``:

1. Recycle: a reservation lives while its job has a task not yet finished;
   dead ones leave, and each queue keeps its live ones in order.
2. Insert: of the ``C`` probes at the head, the prefix whose jobs have
   arrived is sent (each a message and a probe; the head moves past them).
   A probe whose job already holds a reservation on its worker, or gains one
   earlier in the same round, merges into it.  The others are appended to
   their worker's queue in list order; a probe that finds its queue full is
   dropped and counted (``res_overflow``).  A round whose whole window was
   ready while the probe after it was ready too counts in ``probe_lag``.
3. Late binding: each idle worker serves the first reservation in its queue
   whose job still has tasks waiting to launch.  A job whose probes were all
   sent, that has a task waiting and no reservation anywhere, is an orphan:
   every idle worker may serve the orphan of lowest job id, if that is lower
   than its own pick.  Among the idle workers serving one job, the k-th by
   worker index gets the job's k-th waiting task, as long as the job has
   one.  Each launch costs two messages.

A task launched at ``t`` finishes at ``t + 3 hop + duration``.  Times are
kept in ``time_dtype`` (the configuration's float32; the control computes
them in bfloat16).
"""

from __future__ import annotations

import math

import torch


def queue_slots(cfg: dict, num_probes: int) -> int:
    """R: the configuration's ``reserve_cap``, or twice the mean probes a
    worker receives over the trace, between 8 and 64."""
    if cfg.get("reserve_cap", 0):
        return int(cfg["reserve_cap"])
    return int(min(max(8, 2 * math.ceil(num_probes / max(cfg["num_workers"], 1))), 64))


def insert_width(cfg: dict, num_probes: int, kmax: int) -> int:
    """C: the configuration's ``probe_window``, or at least 256 probes, four
    of the largest jobs' probes and a 32nd of the list."""
    if num_probes <= 0:
        return 1
    if cfg.get("probe_window", 0):
        return int(min(cfg["probe_window"], num_probes))
    return int(min(num_probes, max(256, 4 * kmax, math.ceil(num_probes / 32))))


def _rank_in_group(keys: torch.Tensor) -> torch.Tensor:
    """For each entry of ``keys [K, N]``, how many entries of the same key
    come before it."""
    K, N = keys.shape
    order = torch.sort(keys, dim=-1, stable=True).indices
    sk = torch.gather(keys, -1, order)
    pos = torch.arange(N, device=keys.device).expand(K, N)
    first = torch.where(torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                                   sk[:, 1:] != sk[:, :-1]], 1), pos, 0)
    first = torch.cummax(first, dim=-1).values
    return torch.empty_like(keys).scatter(-1, order, pos - first)


def simulate(cfg: dict, inputs: dict, num_rounds: int, time_dtype=torch.float32) -> dict:
    """Run ``num_rounds`` rounds for K points at once.

    ``inputs``: ``job int64[T]``, ``duration [T]``, ``job_ntasks [J]``
    (shared), ``submit [K, T]``, ``job_submit [K, J]`` and ``targets
    int64[K, J, kmax]``, on one device.  Returns ``task_finish [K, T]`` (inf
    where never launched), ``t [K]`` and the counters ``messages``,
    ``probes``, ``res_overflow``, ``probe_lag``, ``inconsistencies``,
    ``repartitions``, ``lost`` (int64[K])."""
    W, d = cfg["num_workers"], cfg["probe_ratio"]
    dt, hop = cfg["dt"], cfg["hop"]
    job = inputs["job"].to(torch.int64)
    dev = job.device
    K, T = inputs["submit"].shape
    ntasks = inputs["job_ntasks"].to(torch.int64)
    J = ntasks.numel()
    inf = float("inf")
    targets = inputs["targets"].to(torch.int64)

    # the probe list: job j's k_j probes, in job order
    k = torch.clamp(d * ntasks, max=W)
    p_job = torch.repeat_interleave(torch.arange(J, device=dev), k)
    p_end = torch.cumsum(k, 0)
    p_col = torch.arange(p_job.numel(), device=dev) - (p_end - k)[p_job]
    P, kmax = int(p_job.numel()), int(k.max())
    R, C = queue_slots(cfg, P), insert_width(cfg, P, kmax)
    p_job = torch.cat([p_job, torch.full((C,), J, dtype=torch.int64, device=dev)])
    p_worker = torch.cat([targets[:, p_job[:P], p_col],
                          torch.zeros((K, C), dtype=torch.int64, device=dev)], 1)
    job_first = torch.cumsum(ntasks, 0) - ntasks
    c_idx = torch.arange(C, device=dev)
    j_all = torch.arange(J, device=dev)

    dur_pad = torch.cat([inputs["duration"].to(time_dtype),
                         torch.zeros(1, dtype=time_dtype, device=dev)])
    submit = inputs["submit"].to(time_dtype)
    jsub_pad = torch.cat([inputs["job_submit"].to(time_dtype),
                          torch.full((K, 1), inf, dtype=time_dtype, device=dev)], 1)
    tf = torch.full((K, T), inf, dtype=time_dtype, device=dev)
    wf = torch.full((K, W), -inf, dtype=time_dtype, device=dev)
    t = torch.zeros(K, dtype=time_dtype, device=dev)
    queue = torch.full((K, W, R), J, dtype=torch.int64, device=dev)
    head = torch.zeros(K, dtype=torch.int64, device=dev)
    z = torch.zeros(K, dtype=torch.int64, device=dev)
    messages, probes, overflow, lag = z.clone(), z.clone(), z.clone(), z.clone()
    kk = torch.arange(K, device=dev)[:, None]

    for _ in range(num_rounds):
        tt = t[:, None]
        idle = wf <= tt

        # 1. recycle the reservations of finished jobs, keep the live in order
        unfinished = torch.zeros((K, J + 1), dtype=torch.int64, device=dev).index_add_(
            1, job, (tf > tt).to(torch.int64))
        live = (queue < J) & (torch.gather(unfinished, 1, queue.reshape(K, -1))
                              .reshape(K, W, R) > 0)
        order = torch.sort((~live).to(torch.int8), dim=-1, stable=True).indices
        live = torch.gather(live, -1, order)
        queue = torch.where(live, torch.gather(queue, -1, order), J)
        fill = live.sum(-1)                                          # [K, W]

        # 2. send the ready prefix of the insertion window
        pos = head[:, None] + c_idx
        wj = p_job[pos]                                              # [K, C]
        ww = torch.gather(p_worker, 1, pos)
        ready = torch.gather(jsub_pad, 1, wj) <= tt
        lead = torch.cumprod(ready.to(torch.int64), -1).sum(-1)
        sent = c_idx[None, :] < lead[:, None]
        nxt = p_job[torch.clamp(head + C, max=p_job.numel() - 1)]
        lagged = (lead == C) & (jsub_pad[kk[:, 0], nxt] <= t)
        pair = torch.where(sent, ww * (J + 1) + wj, -1)
        earlier = _rank_in_group(pair) > 0
        held = (queue[kk, ww] == wj[..., None]).any(-1)
        keep = sent & ~earlier & ~held
        slot = fill[kk, ww] + _rank_in_group(torch.where(keep, ww, W))
        fits = keep & (slot < R)
        qk, qc = fits.nonzero(as_tuple=True)
        queue[qk, ww[qk, qc], slot[qk, qc]] = wj[qk, qc]
        overflow = overflow + (keep & ~fits).sum(-1)
        lag = lag + lagged.to(torch.int64)
        head = head + lead
        messages = messages + lead
        probes = probes + lead

        # 3. late binding
        waiting = torch.isinf(tf) & (tf > 0) & (submit <= tt)        # not launched, arrived
        n_wait = torch.zeros((K, J + 1), dtype=torch.int64, device=dev).index_add_(
            1, job, waiting.to(torch.int64))
        useful = (queue < J) & (torch.gather(n_wait, 1, queue.reshape(K, -1))
                                .reshape(K, W, R) > 0)
        first = torch.where(useful, torch.arange(R, device=dev), R).amin(-1)
        pick = torch.where(first < R, torch.gather(queue, -1, first.clamp(max=R - 1)[..., None])
                           .squeeze(-1), J)
        holds = torch.zeros((K, J + 1), dtype=torch.bool, device=dev)
        holds[kk[:, :, None].expand(K, W, R), queue] = True
        orphan = (p_end[None, :] <= head[:, None]) & (n_wait[:, :J] > 0) & ~holds[:, :J]
        rescue = torch.where(orphan, j_all, J).amin(-1)
        pick = torch.where(idle, torch.minimum(pick, rescue[:, None]), J)
        nth = _rank_in_group(pick)
        pj = pick.clamp(max=J - 1)
        serve = (pick < J) & (nth < torch.gather(n_wait, 1, pj))
        # the r-th waiting task of each job, by task index
        wrank = torch.cumsum(waiting.to(torch.int64), -1)
        before_job = torch.gather(
            torch.cat([torch.zeros((K, 1), dtype=torch.int64, device=dev), wrank], 1),
            1, job_first[None, :].expand(K, J))
        dest = torch.where(waiting, job_first[job][None, :] + wrank - 1
                           - torch.gather(before_job, 1, job[None, :].expand(K, T)), T)
        nth_task = torch.full((K, T + 1), T, dtype=torch.int64, device=dev).scatter(
            1, dest, torch.arange(T, device=dev).expand(K, T))
        task = torch.where(serve, torch.gather(nth_task, 1, (job_first[pj] + nth)
                                               .clamp(max=T - 1)), T)
        fin = (t + 3 * hop)[:, None] + dur_pad[task]
        wf = torch.where(serve, fin, wf)
        sk, sw = serve.nonzero(as_tuple=True)
        tf[sk, task[sk, sw]] = fin[sk, sw]
        messages = messages + 2 * serve.sum(-1)
        t = t + dt

    return dict(task_finish=tf, t=t, messages=messages, probes=probes,
                res_overflow=overflow, probe_lag=lag, inconsistencies=z.clone(),
                repartitions=z.clone(), lost=z.clone())
