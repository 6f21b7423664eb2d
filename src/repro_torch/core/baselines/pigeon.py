"""Pigeon (Wang et al., SoCC'19): federated two-layer scheduling (paper
§2.2.4).

- The DC is divided into fixed groups, each run by a *group coordinator* that
  has up-to-date knowledge of its own group only.
- Top-level *distributors* receive jobs and spread each job's tasks evenly
  (round-robin, task by task) across ALL coordinators — load balancing by the
  law of large numbers, with no global knowledge and no job-type awareness.
- Each group reserves a few workers for high-priority (short) tasks only.
  High-priority tasks: try an unreserved worker first, then a reserved one,
  else enqueue in the high-priority queue.  Low-priority tasks: unreserved
  workers only, else the low-priority queue.
- Dequeue follows weighted fair queuing: for every ``weight`` high-priority
  tasks, one low-priority task is served (prevents starvation).
- The key pathology Megha fixes: once a task is at a coordinator it can never
  migrate, so it queues even when other groups have idle workers.

A copy of ``repro/core/baselines/pigeon.py``, with its imports rewired to the
port's own ``core`` and ``workload`` modules (the port imports nothing of
the reference).
"""

from __future__ import annotations

import math

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.base import JobState, LONG_JOB_THRESHOLD, Scheduler
from repro_torch.core.events import EventLoop
from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Job


@dataclass
class PigeonConfig:
    num_workers: int
    num_distributors: int = 5
    group_size: int = 40
    reserved_per_group: int = 2      # high-priority-only workers per group
    weight: int = 4                  # WFQ: one low per `weight` high tasks
    long_threshold: float = LONG_JOB_THRESHOLD
    seed: int = 0

    @property
    def num_groups(self) -> int:
        return max(1, self.num_workers // self.group_size)


@dataclass
class _QTask:
    js: JobState
    ti: int
    enqueue_time: float
    high: bool


class _Coordinator:
    def __init__(self, gid: int, sched: "Pigeon") -> None:
        self.gid = gid
        self.sched = sched
        cfg = sched.cfg
        base = gid * cfg.group_size
        size = cfg.group_size if gid < cfg.num_groups - 1 else cfg.num_workers - base
        # the first `reserved_per_group` workers of each group are reserved
        self.reserved_free: set[int] = set(range(base, base + min(cfg.reserved_per_group, size)))
        self.unreserved_free: set[int] = set(range(base + min(cfg.reserved_per_group, size), base + size))
        self.high_q: deque[_QTask] = deque()
        self.low_q: deque[_QTask] = deque()
        self._since_low = 0  # WFQ counter

    # -- task intake -----------------------------------------------------------
    def on_task(self, js: JobState, ti: int, high: bool) -> None:
        tr = js.task_records[ti]
        tr.d_comm += self.sched.hop  # distributor -> coordinator hop
        # the coordinator considers the task from the moment it arrives
        if math.isnan(tr.first_attempt_time):
            tr.first_attempt_time = self.sched.loop.now
        if high:
            w = self._take(self.unreserved_free) or self._take(self.reserved_free)
        else:
            w = self._take(self.unreserved_free)
        if w is not None:
            self._launch(js, ti, w, 0.0)
        else:
            q = self.high_q if high else self.low_q
            q.append(_QTask(js, ti, self.sched.loop.now, high))

    @staticmethod
    def _take(s: set[int]) -> Optional[int]:
        if not s:
            return None
        w = min(s)
        s.discard(w)
        return w

    def _launch(self, js: JobState, ti: int, w: int, queue_wait: float) -> None:
        js.running += 1
        tr = js.task_records[ti]
        tr.d_queue_scheduler += queue_wait  # coordinator-side queuing
        tr.d_comm += self.sched.hop         # coordinator -> worker
        self.sched.metrics.messages += 1
        start = self.sched.loop.now + self.sched.hop
        finish = start + js.job.durations[ti]

        def run() -> None:
            tr.start_time = start
            if math.isnan(tr.first_start_time):
                tr.first_start_time = start
            tr.placed_worker = w
            tr.placed_entity = self.gid
            self.sched.loop.push_at(finish, lambda: self._complete(js, ti, w, finish))

        self.sched.loop.push_at(start, run)

    def _complete(self, js: JobState, ti: int, w: int, finish: float) -> None:
        self.sched._finish_task(js, ti, finish)
        reserved = w in self._reserved_range()
        # pick the next task per weighted fair queuing (§2.2.4)
        nxt = self._dequeue(reserved_worker=reserved)
        if nxt is not None:
            self._launch(nxt.js, nxt.ti, w, max(0.0, self.sched.loop.now - nxt.enqueue_time))
            return
        (self.reserved_free if reserved else self.unreserved_free).add(w)

    def _reserved_range(self) -> range:
        base = self.gid * self.sched.cfg.group_size
        return range(base, base + self.sched.cfg.reserved_per_group)

    def _dequeue(self, reserved_worker: bool) -> Optional[_QTask]:
        """WFQ: serve one low-priority task per `weight` high-priority tasks.
        Reserved workers may only serve high-priority tasks."""
        if reserved_worker:
            return self.high_q.popleft() if self.high_q else None
        take_low = (
            self.low_q
            and (self._since_low >= self.sched.cfg.weight or not self.high_q)
        )
        if take_low:
            self._since_low = 0
            return self.low_q.popleft()
        if self.high_q:
            self._since_low += 1
            return self.high_q.popleft()
        return None


class _Distributor:
    def __init__(self, did: int, sched: "Pigeon") -> None:
        self.did = did
        self.sched = sched
        self._rr = did  # decorrelate distributors' round-robin starts

    def on_job(self, job: Job) -> None:
        js = JobState(job, arrival_time=self.sched.loop.now)
        self.sched._register(js)
        for tr in js.task_records.values():
            tr.d_comm += self.sched.hop  # client -> distributor
        high = job.estimated_duration < self.sched.cfg.long_threshold
        coords = self.sched.coordinators
        for ti in list(js.pending):
            js.pending.remove(ti)
            c = coords[self._rr % len(coords)]
            self._rr += 1
            self.sched.loop.push(
                self.sched.hop, lambda c=c, js=js, ti=ti: c.on_task(js, ti, high)
            )
            self.sched.metrics.messages += 1


class Pigeon(Scheduler):
    name = "pigeon"

    def __init__(self, loop: EventLoop, metrics: RunMetrics, cfg: PigeonConfig) -> None:
        super().__init__(loop, metrics)
        self.cfg = cfg
        self.coordinators = [_Coordinator(g, self) for g in range(cfg.num_groups)]
        self.distributors = [_Distributor(d, self) for d in range(cfg.num_distributors)]
        self._next = 0

    def submit(self, job: Job) -> None:
        d = self.distributors[self._next]
        self._next = (self._next + 1) % self.cfg.num_distributors
        self.loop.push(self.hop, lambda: d.on_job(job))
