"""Vectorized Megha state machine: the serving engine's fast path.

Port of ``repro/core/fastpath.py``.  The event simulator in ``megha.py`` is
the faithful reference; this module re-expresses one GM scheduling round as
fixed-shape tensor ops, so that a frontend router can make tens of
thousands of placement decisions per second (§2.3.2 targets 40k-1M SDPS).
Used by ``serve/engine.py`` and the SDPS measurement of ``chip_smoke.py``.

State layout (single resource unit per worker, §4.1):
  truth:  bool[W]     authoritative availability (conceptually sharded per
                      LM; kept as one tensor here, the LM boundary is a
                      partition of the index space)
  view:   bool[W]     one GM's eventually-consistent copy
  order:  int32[W]    one GM's priority permutation over workers (internal
                      partitions first, then external, shuffled per GM per
                      §3.3)

One round = match (the single-row kernel, with its inverse scatter fused)
-> verify-and-commit at the LM -> inconsistency repair (failed tasks
reported back; view refreshed from the piggybacked truth).  Every function
returns new tensors and leaves its inputs as they were, as the reference's
do, and none reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def make_orders(
    num_workers: int, num_gms: int, num_lms: int, seed: int = 0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Per-GM priority permutations int32[G, W]: own partitions (shuffled)
    first, then external partitions (shuffled), mirroring
    GlobalManager.__init__.  Drawn with numpy from ``seed`` exactly as the
    reference draws them, so the two are equal bitwise."""
    if num_workers % (num_gms * num_lms):
        raise ValueError("num_workers must divide evenly into GM x LM partitions")
    wpl = num_workers // num_lms
    psz = wpl // num_gms
    rng = np.random.default_rng(seed)
    orders = np.empty((num_gms, num_workers), np.int32)
    for g in range(num_gms):
        internal, external = [], []
        for l in range(num_lms):
            for g2 in range(num_gms):
                part = np.arange(l * wpl + g2 * psz, l * wpl + (g2 + 1) * psz)
                (internal if g2 == g else external).append(part)
        internal = np.concatenate(internal)
        external = np.concatenate(external)
        rng.shuffle(internal)
        rng.shuffle(external)
        orders[g] = np.concatenate([internal, external])
    return torch.from_numpy(orders).to(resolve_device(device))


class RoundResult(NamedTuple):
    truth: torch.Tensor         # updated ground truth
    view: torch.Tensor          # updated GM view (repaired on inconsistency)
    workers: torch.Tensor       # int32[max_tasks] worker id per task, -1 unplaced
    valid: torch.Tensor         # bool[max_tasks] LM verification verdict
    n_inconsistent: torch.Tensor  # int32[]


def gm_round(
    truth: torch.Tensor,
    view: torch.Tensor,
    order: torch.Tensor,
    n_tasks: torch.Tensor | int,
    *,
    max_tasks: int,
    use_kernel: bool = True,
) -> RoundResult:
    """One GM scheduling round against the LM ground truth.

    1. match: rank free workers in the GM's (stale) view, priority order.
    2. verify-and-commit: the LM checks each mapping against truth; valid
       mappings launch (truth := busy), invalid ones are inconsistencies.
    3. repair: the GM marks its placements busy in its view; on any
       inconsistency the piggybacked LM state overwrites the view (§3.4.1;
       the full view is refreshed, per-LM granularity is a refinement).

    The view update clips -1 worker ids to 0 and scatters in entry order,
    as the reference does (``kops.set_last_writer_wins``): when worker 0 is
    placed with fewer than ``max_tasks`` tasks, the trailing -1 entries
    write worker 0's old view value back, and the view keeps it free."""
    avail_ordered = view[order]  # GM's priority-ordered availability
    asg_pos, _ = kops.match_tasks(avail_ordered, n_tasks, max_tasks, use_kernel=use_kernel)
    workers = torch.where(asg_pos >= 0, order[asg_pos.clamp(0, order.shape[0] - 1)], -1)
    new_truth, valid = kops.verify_and_commit(truth, workers)
    n_bad = ((workers >= 0) & ~valid).sum(dtype=torch.int32)
    # GM view: mark everything we tried as busy ...
    safe = workers.clamp(0, view.shape[0] - 1)
    view2 = kops.set_last_writer_wins(view, safe, torch.where(workers >= 0, False, view[safe]))
    # ... and on inconsistency adopt the piggybacked truth wholesale
    view3 = torch.where(n_bad > 0, new_truth, view2)
    workers_final = torch.where(valid, workers, -1)
    return RoundResult(new_truth, view3, workers_final, valid, n_bad)


def complete(
    truth: torch.Tensor, view: torch.Tensor, workers: torch.Tensor, borrowed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Task completions: free workers in truth; the scheduling GM's view only
    regains NON-borrowed workers (§3.4 — borrowed ones wait for a heartbeat).
    Both scatters clip and keep the last writer, as the reference's do."""
    truth2 = kops.release(truth, workers)
    keep = (workers >= 0) & ~borrowed
    safe = workers.clamp(0, view.shape[0] - 1)
    view2 = kops.set_last_writer_wins(view, safe, torch.where(keep, True, view[safe]))
    return truth2, view2


def heartbeat(view: torch.Tensor, truth: torch.Tensor, lm_slice: torch.Tensor) -> torch.Tensor:
    """Periodic LM state update: overwrite the view for one LM's index range.
    ``lm_slice`` is a bool[W] mask selecting that LM's workers."""
    return torch.where(lm_slice, truth, view)
