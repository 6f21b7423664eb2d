"""Plain PyTorch versions of the rank-and-select kernels.

Port of ``repro/kernels/ref.py``: ``match_ranks_ref``,
``match_ranks_batched_ref``, ``match_tasks_ref`` and ``verify_ref``.  They
are what the wrappers in ``match.py`` run for a tensor on the CPU, and what
the CUDA kernels are held against on the card.  Ranks stay int32, as in the
reference (``torch.cumsum`` would widen to int64 unless told otherwise).
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
