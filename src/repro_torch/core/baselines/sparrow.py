"""Sparrow (Ousterhout et al., SOSP'13): distributed scheduling with batch
sampling + late binding (paper §2.2.2).

Per job of n tasks the scheduler probes d*n distinct random workers; each
probe enqueues a *reservation* at the worker.  When a reservation reaches the
head of a worker's queue, the worker RPCs the scheduler, which hands it the
next unlaunched task of the job (late binding) or a cancel.  There is no
scheduler-side queue (d_queue_scheduler = 0); the cost shows up as
worker-side queuing plus the extra get-task round trip.

A copy of ``repro/core/baselines/sparrow.py``, with its imports rewired to the
port's own ``core`` and ``workload`` modules (the port imports nothing of
the reference).
"""

from __future__ import annotations

import math
import random
from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.base import JobState, Scheduler
from repro_torch.core.events import EventLoop
from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Job


@dataclass
class SparrowConfig:
    num_workers: int
    num_schedulers: int = 10
    probe_ratio: int = 2  # d
    seed: int = 0


@dataclass
class _Reservation:
    job_id: int
    scheduler: "._SparrowScheduler"
    enqueue_time: float


class _Worker:
    __slots__ = ("wid", "sched", "queue", "busy")

    def __init__(self, wid: int, sched: "Sparrow") -> None:
        self.wid = wid
        self.sched = sched
        self.queue: deque[_Reservation] = deque()
        self.busy = False

    def enqueue(self, r: _Reservation) -> None:
        self.queue.append(r)
        self._maybe_next()

    def _maybe_next(self) -> None:
        if self.busy or not self.queue:
            return
        self.busy = True
        r = self.queue.popleft()
        # late binding: worker -> scheduler RPC (1 hop), response (1 hop)
        self.sched.metrics.messages += 2
        self.sched.loop.push(
            self.sched.hop, lambda: r.scheduler.get_task(r, self)
        )

    def assign(self, js: JobState, ti: int, queue_wait: float) -> None:
        """Called (after the RPC round trip) with a concrete task."""
        now = self.sched.loop.now
        tr = js.task_records[ti]
        tr.start_time = now
        if math.isnan(tr.first_start_time):
            tr.first_start_time = now
        tr.placed_worker = self.wid
        tr.placed_entity = js.job.job_id % self.sched.cfg.num_schedulers
        tr.d_queue_worker = queue_wait
        finish = now + js.job.durations[ti]
        self.sched.loop.push_at(finish, lambda: self._finish(js, ti, finish))

    def _finish(self, js: JobState, ti: int, finish: float) -> None:
        self.sched._finish_task(js, ti, finish)
        self.busy = False
        self._maybe_next()

    def cancelled(self) -> None:
        self.busy = False
        self._maybe_next()


class _SparrowScheduler:
    def __init__(self, sid: int, parent: "Sparrow") -> None:
        self.sid = sid
        self.parent = parent
        self.jobs: dict[int, JobState] = {}
        self.rng = random.Random(parent.cfg.seed * 977 + sid)

    def on_job(self, job: Job) -> None:
        js = JobState(job, arrival_time=self.parent.loop.now)
        self.jobs[job.job_id] = js
        self.parent._register(js)
        for tr in js.task_records.values():
            tr.d_comm += self.parent.hop  # client -> scheduler
            # probes go out now: the whole job is under active consideration
            tr.first_attempt_time = self.parent.loop.now
        n = job.num_tasks
        d = self.parent.cfg.probe_ratio
        k = min(d * n, self.parent.cfg.num_workers)
        targets = self.rng.sample(range(self.parent.cfg.num_workers), k)
        for w in targets:
            self.parent.metrics.probes += 1
            self.parent.metrics.messages += 1
            r = _Reservation(job.job_id, self, self.parent.loop.now)
            self.parent.loop.push(
                self.parent.hop,
                lambda w=w, r=r: self.parent.workers[w].enqueue(r),
            )

    def get_task(self, r: _Reservation, worker: _Worker) -> None:
        """Late-binding RPC: give the worker the next unlaunched task."""
        js = self.jobs.get(r.job_id)
        loop = self.parent.loop
        if js is None or not js.pending:
            loop.push(self.parent.hop, worker.cancelled)
            return
        ti = js.pending.pop(0)
        js.running += 1
        tr = js.task_records[ti]
        # probe hop + RPC round trip
        tr.d_comm += 3 * self.parent.hop
        queue_wait = loop.now - self.parent.hop - r.enqueue_time
        loop.push(
            self.parent.hop,
            lambda: worker.assign(js, ti, max(0.0, queue_wait)),
        )


class Sparrow(Scheduler):
    name = "sparrow"

    def __init__(self, loop: EventLoop, metrics: RunMetrics, cfg: SparrowConfig) -> None:
        super().__init__(loop, metrics)
        self.cfg = cfg
        self.workers = [_Worker(i, self) for i in range(cfg.num_workers)]
        self.schedulers = [_SparrowScheduler(i, self) for i in range(cfg.num_schedulers)]
        self._next = 0

    def submit(self, job: Job) -> None:
        s = self.schedulers[self._next]
        self._next = (self._next + 1) % self.cfg.num_schedulers
        self.loop.push(self.hop, lambda: s.on_job(job))
