"""Plain PyTorch versions of the hand-written kernels.

Port of ``repro/kernels/ref.py``: ``match_ranks_ref``,
``match_ranks_batched_ref``, ``match_tasks_ref`` and ``verify_ref``.  They
are what the wrappers in ``match.py`` run for a tensor on the CPU, and what
the CUDA kernels are held against on the card.  Ranks stay int32, as in the
reference (``torch.cumsum`` would widen to int64 unless told otherwise).

Beside them, the reservation-queue passes of the sparrow and eagle rules
(``queue_compact_ref``, ``queue_scan_ref``, ``queue_head_ref``, with
``jobs_with_reservation_ref`` and ``scan_rows``): the element-wise chains
that ``repro_torch/simx/sparrow.py`` ran over the queues, moved here
unchanged, which ``queues.py`` runs for a tensor on the CPU and its CUDA
kernels are held against; and ``task_scan_ref``, the rules' pass over the
task axis (per-job counts and the pending list), behind ``tasks.py``.
"""

from __future__ import annotations

import torch


def match_ranks_ref(avail: torch.Tensor, n_tasks: torch.Tensor | int) -> torch.Tensor:
    """Per-worker task rank for the GM match operation.

    ``avail`` int8/int32/bool[W] — 1 where the (priority-ordered) worker is
    free; ``n_tasks`` — tasks to place.  Returns int32[W]: the task index
    assigned to each ordered worker position, -1 where the worker is busy
    or all tasks were already placed."""
    a = avail.to(torch.int32)
    rank = torch.cumsum(a, dim=0, dtype=torch.int32) - 1
    n = torch.as_tensor(n_tasks, dtype=torch.int32, device=a.device)
    take = (a > 0) & (rank < n)
    return torch.where(take, rank, torch.full_like(rank, -1))


def match_ranks_batched_ref(avail: torch.Tensor, n_tasks: torch.Tensor) -> torch.Tensor:
    """``match_ranks_ref`` over a leading GM axis: ``avail`` [G, W],
    ``n_tasks`` int32[G] -> int32[G, W] ranks, -1 where none is assigned."""
    a = avail.to(torch.int32)
    rank = torch.cumsum(a, dim=-1, dtype=torch.int32) - 1
    n = torch.as_tensor(n_tasks, dtype=torch.int32, device=a.device)[..., None]
    take = (a > 0) & (rank < n)
    return torch.where(take, rank, torch.full_like(rank, -1))


def match_tasks_ref(
    avail: torch.Tensor, n_tasks: torch.Tensor | int, max_tasks: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full match: task -> ordered-worker-position assignment.

    Returns ``assignment`` int32[max_tasks] (the ordered worker position of
    each task, -1 where unplaced) and ``placed`` int32[] (the number of
    lanes given a rank).  The inverse scatter ``out[rank] = position``
    writes into a sentinel slot ``max_tasks`` that is sliced off, standing
    in for the reference's ``mode="drop"``: ranks are unique, so no two
    lanes write one real slot."""
    ranks = match_ranks_ref(avail, n_tasks)
    w = avail.shape[0]
    out = torch.full((max_tasks + 1,), -1, dtype=torch.int32, device=avail.device)
    idx = torch.where((ranks >= 0) & (ranks < max_tasks), ranks, max_tasks)
    positions = torch.arange(w, dtype=torch.int32, device=avail.device)
    out = out.index_put((idx.to(torch.int64),), positions)[:max_tasks]
    placed = (ranks >= 0).sum(dtype=torch.int32)
    return out, placed


def verify_ref(truth: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """LM-side verification oracle: for each assigned worker position, is it
    *actually* free in the LM's ground truth?  -1 assignments are invalid."""
    safe = assignment.clamp(0, truth.shape[0] - 1)
    ok = truth.to(torch.bool)[safe]
    return ok & (assignment >= 0)


# ---------------------------------------------------------------------------
# the reservation queues (``queues.py``)
# ---------------------------------------------------------------------------


def scan_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sums of ``x`` (bool or int32) along its last
    axis: one scan over the flattened tensor, less each row's preceding
    total.  Integer sums are exact, so this equals ``torch.cumsum(x, -1)``
    while the whole tensor's sum fits in int32.  On the card PyTorch scans
    a last axis row by row, which is slow for many short rows (the ``[B, W,
    R]`` queues) and for a few long ones (the ``[B, T]`` pending mask); a
    flat scan is one device-wide pass."""
    x = x.to(torch.int32)
    if x.numel() >= 1 << 31:
        return torch.cumsum(x, dim=-1, dtype=torch.int32)
    flat = torch.cumsum(x.reshape(-1), dim=0, dtype=torch.int32).reshape(x.shape)
    return flat - (flat[..., :1] - x[..., :1])


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` per point: ``table [*P, N]`` and ``idx [*P, ...]``
    (any trailing axes) give ``idx``'s shape."""
    idx = idx.to(torch.int64)
    if table.dim() == 1:
        return table[idx]
    flat = idx.reshape(table.shape[:-1] + (-1,))
    return torch.gather(table, -1, flat).reshape(idx.shape)


def queue_compact_ref(
    resq: torch.Tensor, unfinished: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Recycle the dead entries of the queues ``resq int32[*P, W, R]`` (J =
    empty) and slide the live ones to the front of each queue in order.
    An entry lives while ``job < J`` and ``unfinished[*P, job] > 0``
    (``unfinished int32[*P, J + 1]``, the last slot the pad).  Returns
    ``(queues int32[*P, W, R], fill int32[*P, W])``, the tail of each queue
    J.  Dead entries go to the pad column R, cut off."""
    num_jobs = unfinished.shape[-1] - 1
    R = resq.shape[-1]
    live = (resq < num_jobs) & (_lookup(unfinished, torch.clamp(resq, max=num_jobs)) > 0)
    pos = scan_rows(live) - 1
    out = torch.full(resq.shape[:-1] + (R + 1,), num_jobs, dtype=torch.int32,
                     device=resq.device)
    out = out.scatter(-1, torch.where(live, pos, R).to(torch.int64), resq)[..., :R]
    return out, torch.sum(live, dim=-1, dtype=torch.int32)


def jobs_with_reservation_ref(
    resq: torch.Tensor, num_jobs: int, dead: torch.Tensor | None = None
) -> torch.Tensor:
    """bool[*P, J] — jobs holding at least one entry of the queues ``resq
    int32[*P, W, R]`` (on a worker not ``dead`` bool[*P, W], where given).
    Every entry that counts writes 1 into its job's slot and the rest
    write the pad slot J, which is cut off.  All writes carry the same
    value, so repeated indices give one result on any device."""
    exists = resq < num_jobs
    if dead is not None:
        exists = exists & ~dead[..., None]
    lead = resq.shape[:-2]
    idx = torch.where(exists, resq, num_jobs).reshape(lead + (-1,)).to(torch.int64)
    out = torch.zeros(lead + (num_jobs + 1,), dtype=torch.uint8, device=resq.device)
    return out.scatter(-1, idx, 1)[..., :num_jobs].to(torch.bool)


def queue_scan_ref(
    resq: torch.Tensor,
    pending: torch.Tensor,
    row_mask: torch.Tensor | None = None,
    dead: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(active bool[*P, W, R], has_res bool[*P, J])`` over the queues
    ``resq int32[*P, W, R]``: an entry is active where ``job < J``,
    ``pending[*P, job] > 0`` (``pending int32[*P, J + 1]``) and, where
    given, its row's ``row_mask`` (bool[*P, W]); ``has_res`` is
    ``jobs_with_reservation_ref(resq, J, dead)``."""
    num_jobs = pending.shape[-1] - 1
    active = (resq < num_jobs) & (_lookup(pending, torch.clamp(resq, max=num_jobs)) > 0)
    if row_mask is not None:
        active = active & row_mask[..., None]
    return active, jobs_with_reservation_ref(resq, num_jobs, dead)


def queue_head_ref(resq: torch.Tensor, ranks: torch.Tensor, num_jobs: int) -> torch.Tensor:
    """int32[*P, W] — each queue's entry at its first lane of rank 0
    (``ranks`` int32, the n = 1 pick's output over the rows of ``resq
    int32[*P, W, R]``, in any shape of the same size), J where a row has
    none.  The argmax over bool becomes one over uint8 (the card has no
    bool ``argmax``); its first-maximum rule is the same."""
    picked = ranks.reshape(resq.shape) == 0
    slot = torch.argmax(picked.to(torch.uint8), dim=-1, keepdim=True)
    head = torch.gather(resq, -1, slot)[..., 0]
    return torch.where(torch.any(picked, dim=-1), head, num_jobs)


# ---------------------------------------------------------------------------
# the task axis (``tasks.py``)
# ---------------------------------------------------------------------------


def task_scan_ref(
    task_finish: torch.Tensor,
    submit: torch.Tensor | None,
    job: torch.Tensor,
    t: torch.Tensor,
    num_jobs: int,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """``(unfinished, pending, plist)`` over ``task_finish float32[*P, T]``
    at ``t [*P]``, ``job`` and ``submit`` shared (``[T]``) or one row per
    point: each job's tasks with ``task_finish > t`` and its tasks not yet
    launched (``isinf``) with ``submit <= t`` (``int32[*P, J + 1]``, the
    last slot the pad job), and each point's pending tasks in ascending
    order, then T (``int32[*P, T]``; the kernel leaves that tail unwritten).
    The pending list is a compaction: each pending task goes to its rank
    among the row's pending tasks, the rest to a pad slot that is cut off.
    With ``submit`` None only ``unfinished`` (the rest None)."""
    lead, T = task_finish.shape[:-1], task_finish.shape[-1]
    tt = t[..., None]
    idx = job.to(torch.int64).expand(lead + (T,))
    table = torch.zeros(lead + (num_jobs + 1,), dtype=torch.int32, device=task_finish.device)
    unfinished = table.scatter_add(-1, idx, (task_finish > tt).to(torch.int32))
    if submit is None:
        return unfinished, None, None
    pend = torch.isinf(task_finish) & (submit <= tt)
    pending = table.scatter_add(-1, idx, pend.to(torch.int32))
    rank = torch.where(pend, scan_rows(pend) - 1, T).to(torch.int64)
    task = torch.arange(T, dtype=torch.int32, device=task_finish.device).expand(lead + (T,))
    plist = torch.full(lead + (T + 1,), T, dtype=torch.int32, device=task_finish.device)
    return unfinished, pending, plist.scatter(-1, rank, task)[..., :T]
