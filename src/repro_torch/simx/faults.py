"""Fault helpers of the simx backend (port of ``repro/simx/faults.py``).

Only ``jobs_with_reservation`` so far: the sparrow and eagle rules use it
for orphan rescue on the fault-free path too (a job whose every probe was
dropped on a full queue).  The fault schedules, the fault stage and the
Fig. 4 sweep come with their slice (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import torch


def jobs_with_reservation(
    resq: torch.Tensor, num_jobs: int, dead: torch.Tensor | None = None
) -> torch.Tensor:
    """bool[..., J] — jobs holding at least one reservation-queue entry (on
    a currently-live worker when ``dead`` bool[..., W] is given), from the
    queues ``resq`` int32[..., W, R] (J = empty slot).

    The reference's scatter-max over the flattened queues, with the empty
    sentinel dropped; here every entry that counts writes 1 into its job's
    slot and the rest write the pad slot J, which is cut off.  All writes
    carry the same value, so repeated indices give one result on any
    device."""
    exists = resq < num_jobs
    if dead is not None:
        exists = exists & ~dead[..., None]
    lead = resq.shape[:-2]
    idx = torch.where(exists, resq, num_jobs).reshape(lead + (-1,)).to(torch.int64)
    out = torch.zeros(lead + (num_jobs + 1,), dtype=torch.uint8, device=resq.device)
    return out.scatter(-1, idx, 1)[..., :num_jobs].to(torch.bool)
