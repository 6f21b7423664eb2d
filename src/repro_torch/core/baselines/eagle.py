"""Eagle (Delgado et al., SoCC'16): hybrid scheduling with Succinct State
Sharing (SSS) and Sticky Batch Probing (paper §2.2.3).

- Long jobs (estimated runtime >= threshold) go to a centralized scheduler
  that has full, current knowledge of the *long partition* (all workers
  except the short-reserved slice) and queues tasks when it is full.
- Short jobs go to distributed schedulers using Sparrow-style batch sampling
  with late binding over ALL workers, refined by SSS:
    * a worker currently running a long task rejects the probe and attaches
      the most recent SS bit-vector (nodes hosting long jobs);
    * the scheduler re-sends rejected probes to workers clear in the SS;
    * probes rejected twice go to random workers in the short partition.
- Sticky batch probing: a worker finishing a task of job J immediately pulls
  J's next unlaunched task, skipping new probes.

A copy of ``repro/core/baselines/eagle.py``, with its imports rewired to the
port's own ``core`` and ``workload`` modules (the port imports nothing of
the reference).
"""

from __future__ import annotations

import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.base import JobState, LONG_JOB_THRESHOLD, Scheduler
from repro_torch.core.events import EventLoop
from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Job


@dataclass
class EagleConfig:
    num_workers: int
    num_schedulers: int = 10        # distributed (short-job) schedulers
    probe_ratio: int = 2
    short_partition_fraction: float = 0.10  # reserved for short tasks only
    long_threshold: float = LONG_JOB_THRESHOLD
    seed: int = 0

    @property
    def short_reserved(self) -> int:
        return max(1, int(self.num_workers * self.short_partition_fraction))


@dataclass
class _Probe:
    job_id: int
    scheduler: object
    enqueue_time: float
    rejections: int = 0


class _Worker:
    __slots__ = ("wid", "sched", "queue", "busy", "running_long", "current", "long_backlog")

    def __init__(self, wid: int, sched: "Eagle") -> None:
        self.wid = wid
        self.sched = sched
        self.queue: deque[_Probe] = deque()
        self.busy = False
        self.running_long = False
        self.current: Optional[tuple[JobState, int]] = None
        # long tasks assigned by the central scheduler while a short task was
        # still running here: the head-of-line blocking case SSS advertises.
        self.long_backlog: deque[tuple[JobState, int, float]] = deque()

    @property
    def long_here(self) -> bool:
        """True iff a long job is running or scheduled on this node — the
        condition under which the node appears in the SS bit-vector."""
        return self.running_long or bool(self.long_backlog)

    # -- short path: probes with late binding --------------------------------
    def probe(self, p: _Probe) -> None:
        if self.long_here:
            # SSS rejection: reply with the freshest SS bit-vector (§2.2.3)
            self.sched.metrics.messages += 1
            ss = self.sched.ss_snapshot()
            self.sched.loop.push(
                self.sched.hop, lambda: p.scheduler.on_rejected(p, ss)
            )
            return
        self.queue.append(p)
        self._maybe_next()

    def _maybe_next(self) -> None:
        if self.busy:
            return
        if self.long_backlog:
            # a centrally-placed long task is waiting behind us: run it first
            ljs, lti, t0 = self.long_backlog.popleft()
            self.assign(ljs, lti, self.sched.loop.now - t0, True)
            return
        if not self.queue:
            return
        self.busy = True
        p = self.queue.popleft()
        self.sched.metrics.messages += 2
        self.sched.loop.push(self.sched.hop, lambda: p.scheduler.get_task(p, self))

    def assign(self, js: JobState, ti: int, queue_wait: float, long: bool) -> None:
        now = self.sched.loop.now
        tr = js.task_records[ti]
        tr.start_time = now
        if math.isnan(tr.first_start_time):
            tr.first_start_time = now
        tr.placed_worker = self.wid
        tr.placed_entity = (
            self.sched.cfg.num_schedulers
            if long
            else js.job.job_id % self.sched.cfg.num_schedulers
        )
        tr.d_queue_worker += max(0.0, queue_wait)
        self.running_long = long
        self.busy = True
        self.current = (js, ti)
        finish = now + js.job.durations[ti]
        self.sched.loop.push_at(finish, lambda: self._finish(js, ti, finish, long))

    def assign_long(self, js: JobState, ti: int) -> None:
        """Central-scheduler placement; if a short task is still running the
        long task waits behind it (head-of-line blocking)."""
        if self.busy:
            self.long_backlog.append((js, ti, self.sched.loop.now))
        else:
            self.assign(js, ti, 0.0, True)

    def _finish(self, js: JobState, ti: int, finish: float, long: bool) -> None:
        self.sched._finish_task(js, ti, finish)
        self.busy = False
        self.running_long = False
        self.current = None
        if self.long_backlog:
            ljs, lti, t0 = self.long_backlog.popleft()
            self.assign(ljs, lti, self.sched.loop.now - t0, True)
            if long:
                self.sched.central.on_long_done_elsewhere(js)
            return
        if long:
            self.sched.central.on_worker_free(self, js)
            return
        # sticky batch probing: keep serving the same job if it has work
        if js.pending:
            nti = js.pending.pop(0)
            js.running += 1
            self.assign(js, nti, 0.0, False)
            return
        self._maybe_next()

    def cancelled(self) -> None:
        self.busy = False
        self._maybe_next()


class _CentralScheduler:
    """Schedules long jobs on the long partition with full knowledge."""

    def __init__(self, sched: "Eagle") -> None:
        self.sched = sched
        self.queue: deque[tuple[JobState, int]] = deque()
        self.free: set[int] = set(
            range(self.sched.cfg.short_reserved, self.sched.cfg.num_workers)
        )

    def on_job(self, job: Job) -> None:
        js = JobState(job, arrival_time=self.sched.loop.now)
        self.sched.jobs[job.job_id] = js
        self.sched._register(js)
        for tr in js.task_records.values():
            tr.d_comm += self.sched.hop
            # the central scheduler considers queued tasks every drain
            tr.first_attempt_time = self.sched.loop.now
        for ti in list(js.pending):
            js.pending.remove(ti)
            self.queue.append((js, ti))
        self._drain()

    def _drain(self) -> None:
        while self.queue and self.free:
            js, ti = self.queue.popleft()
            w = min(self.free)
            self.free.discard(w)
            self.sched.long_nodes.add(w)
            js.running += 1
            tr = js.task_records[ti]
            tr.d_queue_scheduler = max(
                0.0, self.sched.loop.now - js.arrival_time - tr.d_queue_scheduler * 0
            )
            tr.d_comm += self.sched.hop  # central -> worker launch
            self.sched.metrics.messages += 1
            worker = self.sched.workers[w]
            self.sched.loop.push(
                self.sched.hop,
                lambda worker=worker, js=js, ti=ti: worker.assign_long(js, ti),
            )

    def on_worker_free(self, worker: "_Worker", js: JobState) -> None:
        # sticky: prefer the same long job's pending tasks
        if js.pending:
            ti = js.pending.pop(0)
            js.running += 1
            worker.assign(js, ti, 0.0, True)
            return
        self.sched.long_nodes.discard(worker.wid)
        self.free.add(worker.wid)
        worker._maybe_next()
        self._drain()

    def on_long_done_elsewhere(self, js: JobState) -> None:
        """A long task finished on a worker that immediately started another
        backlogged long task; hand the job's remaining work to _drain."""
        if js.pending:
            ti = js.pending.pop(0)
            self.queue.appendleft((js, ti))
        self._drain()


class _DistScheduler:
    """Sparrow-style short-job scheduler refined with SSS."""

    def __init__(self, sid: int, sched: "Eagle") -> None:
        self.sid = sid
        self.sched = sched
        self.rng = random.Random(sched.cfg.seed * 131 + sid)
        self.ss: frozenset[int] = frozenset()  # last seen SS bit-vector

    def on_job(self, job: Job) -> None:
        js = JobState(job, arrival_time=self.sched.loop.now)
        self.sched.jobs[job.job_id] = js
        self.sched._register(js)
        for tr in js.task_records.values():
            tr.d_comm += self.sched.hop
            # probes go out now: the whole job is under active consideration
            tr.first_attempt_time = self.sched.loop.now
        cfg = self.sched.cfg
        k = min(cfg.probe_ratio * job.num_tasks, cfg.num_workers)
        # avoid nodes we already believe are running long jobs
        candidates = [w for w in range(cfg.num_workers) if w not in self.ss]
        if len(candidates) < k:
            candidates = list(range(cfg.num_workers))
        for w in self.rng.sample(candidates, k):
            self._send_probe(w, _Probe(job.job_id, self, self.sched.loop.now))

    def _send_probe(self, w: int, p: _Probe) -> None:
        self.sched.metrics.probes += 1
        self.sched.metrics.messages += 1
        p.enqueue_time = self.sched.loop.now
        self.sched.loop.push(
            self.sched.hop, lambda: self.sched.workers[w].probe(p)
        )

    def on_rejected(self, p: _Probe, ss: frozenset[int]) -> None:
        self.ss = ss  # adopt the most recent SS (§2.2.3)
        p.rejections += 1
        cfg = self.sched.cfg
        if p.rejections == 1:
            clear = [w for w in range(cfg.num_workers) if w not in ss]
            if clear:
                self._send_probe(self.rng.choice(clear), p)
                return
        # rejected twice (or SS shows nothing clear): random short-partition node
        self._send_probe(self.rng.randrange(cfg.short_reserved), p)

    def get_task(self, p: _Probe, worker: "_Worker") -> None:
        js = self.sched.jobs.get(p.job_id)
        loop = self.sched.loop
        if js is None or not js.pending:
            loop.push(self.sched.hop, worker.cancelled)
            return
        ti = js.pending.pop(0)
        js.running += 1
        tr = js.task_records[ti]
        tr.d_comm += 3 * self.sched.hop
        queue_wait = loop.now - self.sched.hop - p.enqueue_time
        loop.push(self.sched.hop, lambda: worker.assign(js, ti, queue_wait, False))


class Eagle(Scheduler):
    name = "eagle"

    def __init__(self, loop: EventLoop, metrics: RunMetrics, cfg: EagleConfig) -> None:
        super().__init__(loop, metrics)
        self.cfg = cfg
        self.jobs: dict[int, JobState] = {}
        self.workers = [_Worker(i, self) for i in range(cfg.num_workers)]
        self.long_nodes: set[int] = set()  # the SS bit-vector, authoritative copy
        self.central = _CentralScheduler(self)
        self.dists = [_DistScheduler(i, self) for i in range(cfg.num_schedulers)]
        self._next = 0

    def ss_snapshot(self) -> frozenset[int]:
        return frozenset(self.long_nodes)

    def submit(self, job: Job) -> None:
        if job.estimated_duration >= self.cfg.long_threshold:
            self.loop.push(self.hop, lambda: self.central.on_job(job))
        else:
            d = self.dists[self._next]
            self._next = (self._next + 1) % self.cfg.num_schedulers
            self.loop.push(self.hop, lambda: d.on_job(job))
