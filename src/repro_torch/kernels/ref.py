"""Plain PyTorch versions of the rank-and-select kernel.

Port of ``repro/kernels/ref.py``'s ``match_ranks_ref`` and
``match_ranks_batched_ref``.  They are what ``match.match_ranks_batched``
runs for a tensor on the CPU, and what the CUDA kernel is held against on
the card.  Ranks stay int32, as in the reference (``torch.cumsum`` would
widen to int64 unless told otherwise).
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
