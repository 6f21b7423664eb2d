"""The user-facing match operations (port of ``repro/kernels/ops.py``).

``match_tasks`` is the vectorized GM match operation of the serving engine
and the SDPS benchmark: on the card one launch of the single-row kernel,
which fuses the reference's inverse scatter (task -> worker position) into
the scan.  ``verify_and_commit`` and ``release`` are the LM side.

Two kinds of scatter stand in for the reference's ``.at[...]`` updates:

* ``mode="drop"`` with an out-of-range index becomes a scatter into a
  sentinel slot that is sliced off (torch has no drop mode);
* a clipped index scattered with ``.set``, where several entries may land
  on one slot (every -1 worker id clips to slot 0), becomes
  ``set_last_writer_wins``: XLA on the CPU applies such a scatter in entry
  order, so the last entry's value stays, and the port reproduces that
  outcome deterministically (``index_put_`` with repeated indices is not
  deterministic on CUDA).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import match, ref


def match_tasks(
    avail: torch.Tensor,
    n_tasks: torch.Tensor | int,
    max_tasks: int,
    *,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match up to ``n_tasks`` tasks onto free workers in priority order.

    ``avail`` bool/int8[W] availability in the GM's priority order;
    ``n_tasks`` a Python int or an int32 on the device, clamped to
    ``max_tasks``.  Returns ``assignment`` int32[max_tasks] (ordered-worker
    position per task, -1 if unplaced) and ``placed`` int32[] (count of
    placed tasks).

    ``use_kernel=True`` is the kernel wrapper (the CUDA kernel for a tensor
    on the card, the plain version on the CPU); ``use_kernel=False`` is the
    plain version on any device, as the reference's ``use_pallas=False``."""
    if use_kernel:
        return match.match_tasks(avail, n_tasks, max_tasks)
    return ref.match_tasks_ref(avail, match.clamp_n(n_tasks, max_tasks), max_tasks)


def set_last_writer_wins(
    dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``dst.at[idx].set(values)`` as XLA applies it on the CPU: entries in
    order, so where ``idx`` repeats, the value of the last such entry
    stays.  ``idx`` must lie in range (the reference clips it first).

    The winning entry of each slot is found by a max-scatter of entry
    indices, which does not depend on the order the device applies it in;
    the slot then takes that entry's value."""
    order = torch.arange(idx.shape[0], dtype=torch.int32, device=dst.device)
    last = torch.full(dst.shape, -1, dtype=torch.int32, device=dst.device).scatter_reduce(
        0, idx.to(torch.int64), order, "amax", include_self=True
    )
    return torch.where(last >= 0, values[last.clamp(min=0)], dst)


def verify_and_commit(
    truth: torch.Tensor, assignment: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM-side verification (§3.3): check each assignment against ground
    truth, commit the valid ones (mark busy), report the invalid ones.

    ``truth`` bool[W] authoritative availability at the LM; ``assignment``
    int32[T] worker positions (-1 = no-op).  Returns the updated
    availability and bool[T] validity per task.

    Duplicate assignments to one worker within a batch are resolved
    first-wins, matching the LM's sequential iteration over the batch
    (§3.4.1): a min-scatter of task indices over ``w + 1`` slots, the last
    one the sentinel of the -1 (and out-of-range) assignments."""
    w = truth.shape[0]
    t = assignment.shape[0]
    dev = truth.device
    safe = assignment.clamp(0, w - 1)
    tasks = torch.arange(t, dtype=torch.int32, device=dev)
    claim_idx = torch.where((assignment >= 0) & (assignment < w), assignment, w)
    first = torch.full((w + 1,), t, dtype=torch.int32, device=dev).scatter_reduce(
        0, claim_idx.to(torch.int64), tasks, "amin", include_self=True
    )[:w]
    is_first = first[safe] == tasks
    valid = (assignment >= 0) & truth[safe] & is_first
    # commit via a claimed mask (duplicate-safe: a later invalid duplicate
    # must not scatter the worker back to free); only the sentinel repeats
    claimed = torch.zeros(w + 1, dtype=truth.dtype, device=dev).index_put(
        (torch.where(valid, safe, w).to(torch.int64),),
        torch.ones((), dtype=truth.dtype, device=dev),
    )[:w]
    return truth & ~claimed, valid


def release(truth: torch.Tensor, workers: torch.Tensor) -> torch.Tensor:
    """Mark completed tasks' workers free again (-1 entries are no-ops,
    except that, as in the reference, a -1 after a real entry for worker 0
    writes worker 0's old value back: see ``set_last_writer_wins``)."""
    safe = workers.clamp(0, truth.shape[0] - 1)
    upd = torch.where(workers >= 0, True, truth[safe])
    return set_last_writer_wins(truth, safe, upd)
