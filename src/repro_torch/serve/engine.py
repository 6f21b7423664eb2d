"""Megha-scheduled inference serving engine (port of ``repro/serve/engine.py``).

The paper's architecture mapped onto an accelerator fleet:

  pods       = LM clusters — each pod's controller owns the ground-truth
               occupancy of its decode slots (a slot = one continuous-
               batching lane on a device group);
  frontends  = GMs — parallel request routers, each holding an eventually-
               consistent view of every pod's slot occupancy;
  requests   = jobs (a batch of requests = a job's tasks).

Placement uses the vectorized fast path (the single-row match kernel +
LM-side verify-and-commit).  Inconsistent placements are repaired exactly
as in the paper: the pod rejects, piggybacks fresh state, and the frontend
retries at the head of its queue.  Freed *borrowed* slots return to their
owner only at the next heartbeat (§3.4).

The engine advances in ticks (one tick ~ one decode macro-step); slot hold
times are simulated from request generation lengths.  Occupancy state
(``truth``, ``views``) lives on the device; the queues, the running map and
the stats live on the host, and each frontend's round is read back with two
host reads (its inconsistency count and its placed workers), as in the
reference.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import fastpath as FP
from repro_torch.device import resolve_device


@dataclass
class Request:
    rid: int
    gen_len: int                 # ticks of decode work
    submit_tick: int = 0
    start_tick: int = -1
    finish_tick: int = -1
    slot: int = -1
    frontend: int = -1

    @property
    def queue_delay(self) -> int:
        return self.start_tick - self.submit_tick


@dataclass
class EngineStats:
    placed: int = 0
    completed: int = 0
    inconsistencies: int = 0
    repartitions: int = 0
    ticks: int = 0
    queue_delays: list = field(default_factory=list)

    def summary(self) -> dict:
        qd = self.queue_delays
        return {
            "placed": self.placed,
            "completed": self.completed,
            "inconsistencies": self.inconsistencies,
            "inconsistency_ratio": self.inconsistencies / max(1, self.placed),
            "repartitions": self.repartitions,
            "ticks": self.ticks,
            "mean_queue_delay": float(np.mean(qd)) if qd else 0.0,
            "p95_queue_delay": float(np.percentile(qd, 95)) if qd else 0.0,
        }


class MeghaServeEngine:
    """``use_kernel`` mirrors the reference's ``use_pallas``; ``device=None``
    means the CUDA card (raises without one), ``device="cpu"`` the CPU.
    ``gm_rounds`` counts the fast-path rounds run (one per frontend with a
    non-empty queue per tick)."""

    def __init__(
        self,
        *,
        num_frontends: int = 4,
        num_pods: int = 4,
        slots_per_pod: int = 64,
        heartbeat_ticks: int = 16,
        max_batch: int = 256,
        seed: int = 0,
        use_kernel: bool = True,
        device: str | torch.device | None = None,
    ) -> None:
        if slots_per_pod % num_frontends:
            raise ValueError("slots_per_pod must divide across frontends (partitions)")
        self.device = resolve_device(device)
        self.g = num_frontends
        self.pods = num_pods
        self.w = num_pods * slots_per_pod
        self.slots_per_pod = slots_per_pod
        self.heartbeat_ticks = heartbeat_ticks
        self.max_batch = max_batch
        self.use_kernel = use_kernel
        self.truth = torch.ones((self.w,), dtype=torch.bool, device=self.device)
        self.views = [
            torch.ones((self.w,), dtype=torch.bool, device=self.device) for _ in range(self.g)
        ]
        self.orders = FP.make_orders(self.w, self.g, num_pods, seed=seed, device=self.device)
        self.queues: list[collections.deque[Request]] = [
            collections.deque() for _ in range(self.g)
        ]
        self.running: dict[int, Request] = {}  # slot -> request
        self.remaining = np.zeros(self.w, np.int64)
        self.stats = EngineStats()
        self.gm_rounds = 0
        self._rr = 0
        self._tick = 0
        # pod masks for heartbeats, built once on the device: row p is pod p
        self._pod_masks = (
            torch.arange(self.w, device=self.device)[None, :] // slots_per_pod
            == torch.arange(num_pods, device=self.device)[:, None]
        )

    # -- request intake (jobs -> GMs round-robin) ---------------------------
    def submit(self, requests: list[Request]) -> None:
        for r in requests:
            r.submit_tick = self._tick
            r.frontend = self._rr
            self.queues[self._rr].append(r)
            self._rr = (self._rr + 1) % self.g

    def _partition_owner(self, slot: int) -> int:
        return (slot % self.slots_per_pod) // (self.slots_per_pod // self.g)

    def _set_true(self, mask: torch.Tensor, slots: list[int]) -> torch.Tensor:
        """``mask`` with ``slots`` (distinct) set True, as a new tensor.  The
        slot ids go to the card from pinned memory without a host sync."""
        pin = self.device.type == "cuda"
        idx = torch.tensor(slots, dtype=torch.int64, pin_memory=pin).to(
            self.device, non_blocking=True)
        return mask.index_put((idx,), torch.ones((), dtype=torch.bool, device=self.device))

    # -- one engine tick ------------------------------------------------------
    def tick(self) -> list[Request]:
        """Schedule queued requests, advance decode, return completions."""
        self._tick += 1
        self.stats.ticks += 1

        # 1) each frontend places what it can (batched verify-and-launch)
        for g in range(self.g):
            q = self.queues[g]
            if not q:
                continue
            n = min(len(q), self.max_batch)
            res = FP.gm_round(
                self.truth, self.views[g], self.orders[g], n,
                max_tasks=self.max_batch, use_kernel=self.use_kernel,
            )
            self.gm_rounds += 1
            self.truth = res.truth
            self.views[g] = res.view
            self.stats.inconsistencies += int(res.n_inconsistent)
            workers = res.workers.cpu().numpy()
            placed_slots = [int(w) for w in workers[:n] if w >= 0]
            for slot in placed_slots:
                r = q.popleft()
                r.slot = slot
                r.frontend = g  # the frontend that actually placed it
                r.start_tick = self._tick
                self.running[slot] = r
                self.remaining[slot] = r.gen_len
                self.stats.placed += 1
                self.stats.queue_delays.append(r.queue_delay)
                if self._partition_owner(slot) != g:
                    self.stats.repartitions += 1

        # 2) decode progress
        occupied = list(self.running.keys())
        if occupied:
            self.remaining[occupied] -= 1

        # 3) completions -> free slots (borrowed ones stay dark to the owner)
        done_slots = [s for s in occupied if self.remaining[s] <= 0]
        completed = []
        if done_slots:
            self.truth = self._set_true(self.truth, done_slots)
            # the scheduling frontend regains only non-borrowed slots (§3.4);
            # borrowed ones stay dark to everyone until a heartbeat
            for g in range(self.g):
                mine = [
                    s for s in done_slots
                    if self.running[s].frontend == g and self._partition_owner(s) == g
                ]
                if mine:
                    self.views[g] = self._set_true(self.views[g], mine)
            for s in done_slots:
                r = self.running.pop(s)
                r.finish_tick = self._tick
                completed.append(r)
                self.stats.completed += 1

        # 4) staggered heartbeats: one pod per interval slot refreshes all views
        if self.heartbeat_ticks:
            interval = max(1, self.heartbeat_ticks // self.pods)
            if self._tick % interval == 0:
                p = (self._tick // interval) % self.pods
                for g in range(self.g):
                    self.views[g] = FP.heartbeat(self.views[g], self.truth, self._pod_masks[p])
        return completed

    def run_until_drained(self, max_ticks: int = 100_000) -> EngineStats:
        for _ in range(max_ticks):
            self.tick()
            if not self.running and all(not q for q in self.queues):
                break
        return self.stats

    @property
    def utilization(self) -> float:
        return len(self.running) / self.w
