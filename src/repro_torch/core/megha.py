"""Megha: federated scheduling with an eventually-consistent global state.

A copy of ``repro/core/megha.py`` (``Megha``, ``MeghaConfig`` and the
GM/LM classes), so the port's event backend imports nothing of the
reference; the reference's ``grid_workers`` lives in ``core/base.py``.

Faithful event-driven implementation of the paper (§3):

* Global Managers (GMs) hold a *stale* copy of the whole DC's worker
  availability, refreshed by periodic LM heartbeats and by piggybacked state
  on inconsistency responses.
* Local Managers (LMs) own the ground truth for their cluster and
  verify-and-launch every mapping (§3.3).
* Each LM's cluster is split into one partition per GM; a GM schedules into
  its *internal* partitions first and *borrows* (repartition, §3.2) from
  external partitions when they are exhausted.
* Requests and responses are batched per LM (§3.4.1) with a bounded batch
  size; invalid mappings return in one response with a piggybacked fresh
  cluster snapshot.
* Task completions flow LM->GM; freed borrowed workers are NOT returned to
  the borrower — the owner rediscovers them via heartbeat (§3.4).
* GMs are stateless and recoverable from heartbeats (§3.5) — exercised by
  ``fail_gm``/``recover_gm``.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.base import JobState, Scheduler
from repro_torch.core.events import EventLoop
from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Job


@dataclass
class MeghaConfig:
    num_workers: int
    num_gms: int = 8
    num_lms: int = 8
    heartbeat_interval: float = 5.0  # §4.1: optimal at 5 s
    batch_limit: int = 64            # §3.4.1: "we limit the size of the batch"
    seed: int = 0

    def __post_init__(self) -> None:
        if self.num_workers % self.num_lms:
            raise ValueError("num_workers must divide evenly across LMs")
        if (self.num_workers // self.num_lms) % self.num_gms:
            raise ValueError("cluster size must divide evenly across GM partitions")

    @property
    def workers_per_lm(self) -> int:
        return self.num_workers // self.num_lms

    @property
    def partition_size(self) -> int:
        return self.workers_per_lm // self.num_gms

    def lm_of(self, worker: int) -> int:
        return worker // self.workers_per_lm

    def partition_gm_of(self, worker: int) -> int:
        """Which GM owns the partition this worker belongs to."""
        return (worker % self.workers_per_lm) // self.partition_size

    def partition_workers(self, lm: int, gm: int) -> range:
        base = lm * self.workers_per_lm + gm * self.partition_size
        return range(base, base + self.partition_size)


class _FreeSet:
    """Per-GM free-worker pool with a GM-specific traversal order.

    The paper reduces inconsistencies "by shuffling the worker nodes and
    partitions in each GM, such that the worker nodes and the partitions
    picked by each GM are different" (§3.3).  A deque + membership set with
    lazy deletion gives O(1) add/discard/pop while each GM walks its own
    shuffled order.
    """

    __slots__ = ("_dq", "_members")

    def __init__(self, items, rng: random.Random) -> None:
        order = list(items)
        rng.shuffle(order)
        self._dq = deque(order)
        self._members = set(order)

    def __len__(self) -> int:
        return len(self._members)

    def __bool__(self) -> bool:
        return bool(self._members)

    def __contains__(self, w: int) -> bool:
        return w in self._members

    def add(self, w: int) -> None:
        if w not in self._members:
            self._members.add(w)
            self._dq.append(w)

    def discard(self, w: int) -> None:
        self._members.discard(w)  # lazy: the deque entry is skipped on pop

    def pop(self) -> int:
        while self._dq:
            w = self._dq.popleft()
            if w in self._members:
                self._members.remove(w)
                return w
        raise KeyError("pop from empty _FreeSet")


@dataclass
class _Mapping:
    """One <task_i, wnode_j> entry of a batched verify-and-launch request."""

    job_id: int
    task_index: int
    worker: int
    duration: float
    borrowed: bool


class LocalManager:
    """Owns ground-truth availability for one cluster (§3.1)."""

    def __init__(self, lm_id: int, cfg: MeghaConfig, sched: "Megha") -> None:
        self.lm_id = lm_id
        self.cfg = cfg
        self.sched = sched
        self.avail = [True] * cfg.workers_per_lm
        self.running: dict[int, tuple[int, int, int]] = {}  # local -> (gm, job, task)
        self.failed = False

    # -- request path ----------------------------------------------------
    def handle_batch(self, gm_id: int, batch: list[_Mapping]) -> None:
        """Verify each mapping against ground truth; launch valid ones and
        batch the invalid ones into a single response with a piggybacked
        cluster snapshot (§3.4.1)."""
        loop = self.sched.loop
        launched: list[_Mapping] = []
        invalid: list[_Mapping] = []
        for m in batch:
            local = m.worker - self.lm_id * self.cfg.workers_per_lm
            if self.avail[local]:
                self.avail[local] = False
                self.running[local] = (gm_id, m.job_id, m.task_index)
                launched.append(m)
                # LM -> worker launch hop
                start = loop.now + self.sched.hop
                loop.push_at(start, lambda m=m, s=start: self._start_task(gm_id, m, s))
            else:
                invalid.append(m)
        snapshot = list(self.avail) if invalid else None
        self.sched.metrics.messages += 1

        def deliver_response():
            # §3.5: the GM may have died while the response was in flight;
            # launched tasks keep running, invalid mappings are dropped (the
            # orphaned job is resubmitted elsewhere by the fault handler)
            gm = self.sched.gms[gm_id]
            if gm is not None:
                gm.on_lm_response(self.lm_id, launched, invalid, snapshot)

        loop.push(self.sched.hop, deliver_response)

    def _start_task(self, gm_id: int, m: _Mapping, start: float) -> None:
        loop = self.sched.loop
        gm = self.sched.gms[gm_id]
        if gm is not None and m.job_id in gm.jobs:
            tr = gm.jobs[m.job_id].task_records[m.task_index]
            tr.start_time = start
            if math.isnan(tr.first_start_time):
                tr.first_start_time = start
            tr.placed_worker = m.worker
            tr.placed_entity = gm_id
        finish = start + m.duration
        local = m.worker - self.lm_id * self.cfg.workers_per_lm
        loop.push_at(finish, lambda: self._complete(local, gm_id, m, finish))

    def _complete(self, local: int, gm_id: int, m: _Mapping, finish: float) -> None:
        self.avail[local] = True
        self.running.pop(local, None)
        self.sched.metrics.messages += 1
        # completion message LM -> scheduling GM (0.5 ms); JRT uses worker
        # finish time, the message only gates *backfill* scheduling (§3.4).
        def deliver_complete():
            gm = self.sched.gms[gm_id]
            if gm is not None:
                gm.on_task_complete(m, finish)
            # a dead scheduling GM drops the message: the freed worker is
            # rediscovered by its partition owner via heartbeat (§3.4)

        self.sched.loop.push(self.sched.hop, deliver_complete)

    # -- state dissemination ----------------------------------------------
    def snapshot(self) -> list[bool]:
        return list(self.avail)

    def heartbeat(self) -> None:
        if self.failed:
            return
        snap = self.snapshot()
        for gm in self.sched.gms:
            if gm is None:
                continue
            self.sched.metrics.messages += 1
            self.sched.loop.push(
                self.sched.hop,
                lambda gm=gm, s=list(snap): gm.on_heartbeat(self.lm_id, s),
            )

    # -- fault injection ---------------------------------------------------
    def fail_worker(self, local: int) -> list[tuple[int, int, int]]:
        """Worker crash: LM restarts it and must re-run its task (§3.5).
        Returns the (gm, job, task) that was lost, for resubmission."""
        lost = []
        if local in self.running:
            lost.append(self.running.pop(local))
        self.avail[local] = True
        return lost


class GlobalManager:
    """A parallel scheduling entity with an eventually-consistent DC view."""

    def __init__(self, gm_id: int, cfg: MeghaConfig, sched: "Megha") -> None:
        self.gm_id = gm_id
        self.cfg = cfg
        self.sched = sched
        self.rng = random.Random(cfg.seed * 1000 + gm_id)
        # view: free-worker pools keyed by (partition_gm, lm), each traversed
        # in a GM-specific shuffled order (§3.3).
        self.free: dict[tuple[int, int], _FreeSet] = {
            (g, l): _FreeSet(cfg.partition_workers(l, g), self.rng)
            for g in range(cfg.num_gms)
            for l in range(cfg.num_lms)
        }
        self.inflight: set[int] = set()  # sent but not yet verified
        self.jobs: dict[int, JobState] = {}
        self.queue: deque[tuple[int, int]] = deque()  # (job_id, task_index)
        self._lm_order = list(range(cfg.num_lms))
        self.rng.shuffle(self._lm_order)
        self._ext_order = [
            (g, l)
            for g in range(cfg.num_gms)
            if g != gm_id
            for l in range(cfg.num_lms)
        ]
        self.rng.shuffle(self._ext_order)
        self._rr = 0      # round-robin pointer over internal LMs (§3.3)
        self._ext_rr = 0  # round-robin pointer over external partitions

    # -- job intake --------------------------------------------------------
    def on_job(self, job: Job) -> None:
        js = JobState(job, arrival_time=self.sched.loop.now)
        self.jobs[job.job_id] = js
        self.sched._register(js)
        for tr in js.task_records.values():
            tr.d_comm += self.sched.hop  # client -> GM hop
        for i in js.pending:
            self.queue.append((job.job_id, i))
        js.pending.clear()
        self.schedule()

    # -- the match operation (§3.2) -----------------------------------------
    def _pick_worker(self) -> Optional[tuple[int, bool]]:
        """Pop an available worker from the GM's view: internal partitions
        round-robin first (saturating each before moving on, §3.4.1), then
        external partitions (repartition).  Returns (worker, borrowed)."""
        g = self.gm_id
        for k in range(self.cfg.num_lms):
            lm = self._lm_order[(self._rr + k) % self.cfg.num_lms]
            s = self.free[(g, lm)]
            if s:
                w = s.pop()
                if not s:  # partition saturated: advance the round-robin
                    self._rr = (self._rr + k + 1) % self.cfg.num_lms
                return w, False
        for j in range(len(self._ext_order)):
            g2, lm = self._ext_order[(self._ext_rr + j) % len(self._ext_order)]
            s = self.free[(g2, lm)]
            if s:
                w = s.pop()
                if not s:
                    self._ext_rr = (self._ext_rr + j + 1) % len(self._ext_order)
                return w, True
        return None

    def schedule(self) -> None:
        """Drain the task queue FIFO; build per-LM batches; stop when the
        view shows no free workers (§3.2)."""
        if self.queue and self.sched.gms[self.gm_id] is not self:
            return  # failed GM
        batches: dict[int, list[_Mapping]] = defaultdict(list)
        now = self.sched.loop.now
        while self.queue:
            job_id, ti = self.queue[0]
            picked = self._pick_worker()
            if picked is None:
                break
            w, borrowed = picked
            self.queue.popleft()
            js = self.jobs[job_id]
            tr = js.task_records[ti]
            # scheduler-side queue delay ends now (Eq. 5)
            if tr.d_queue_scheduler == 0.0:
                tr.d_queue_scheduler = max(0.0, now - js.arrival_time)
            if math.isnan(tr.first_attempt_time):
                tr.first_attempt_time = now
            lm = self.cfg.lm_of(w)  # the worker was already popped from the view
            self.inflight.add(w)
            if borrowed:
                self.sched.metrics.repartitions += 1
            batches[lm].append(
                _Mapping(job_id, ti, w, js.job.durations[ti], borrowed)
            )
            js.running += 1
            if len(batches[lm]) >= self.cfg.batch_limit:
                self._send(lm, batches.pop(lm))
        for lm, batch in batches.items():
            self._send(lm, batch)

    def _send(self, lm: int, batch: list[_Mapping]) -> None:
        for m in batch:
            tr = self.jobs[m.job_id].task_records[m.task_index]
            tr.d_comm += 2 * self.sched.hop  # GM->LM and LM->worker hops
        self.sched.metrics.messages += 1
        self.sched.loop.push(
            self.sched.hop, lambda: self.sched.lms[lm].handle_batch(self.gm_id, batch)
        )

    # -- LM responses --------------------------------------------------------
    def on_lm_response(
        self,
        lm_id: int,
        launched: list[_Mapping],
        invalid: list[_Mapping],
        snapshot: Optional[list[bool]],
    ) -> None:
        for m in launched:
            self.inflight.discard(m.worker)
        if invalid:
            self.sched.metrics.inconsistencies += len(invalid)
            # patch the stale view with the piggybacked truth (§3.4.1) ...
            if snapshot is not None:
                self.on_heartbeat(lm_id, snapshot)
            # ... and retry the invalid tasks at the FRONT of the queue.
            for m in reversed(invalid):
                self.inflight.discard(m.worker)
                js = self.jobs.get(m.job_id)
                if js is None:
                    # §3.5: a recovered (stateless) GM may receive responses
                    # to its predecessor's proposals; the orphaned job was
                    # resubmitted elsewhere, so drop the mapping
                    continue
                js.running -= 1
                tr = js.task_records[m.task_index]
                tr.d_comm += self.sched.hop  # the inconsistency response hop
                tr.stale_retries += 1
                # the proposal + invalid-response round trip was pure waste
                tr.stale_retry_time += 2 * self.sched.hop
                self.queue.appendleft((m.job_id, m.task_index))
            self.schedule()

    def on_task_complete(self, m: _Mapping, finish: float) -> None:
        js = self.jobs.get(m.job_id)
        if js is None:
            # §3.5: a recovered (stateless) GM may receive completions for
            # tasks launched by its predecessor; reclaim the worker, the
            # resubmitted job re-runs the task.
            if not m.borrowed:
                self.free[
                    (self.cfg.partition_gm_of(m.worker), self.cfg.lm_of(m.worker))
                ].add(m.worker)
            self.schedule()
            return
        self.sched._finish_task(js, m.task_index, finish)
        if not m.borrowed:
            # the worker returns to our view immediately; a borrowed worker
            # is only rediscovered by its owner via heartbeat (§3.4)
            self.free[(self.cfg.partition_gm_of(m.worker), self.cfg.lm_of(m.worker))].add(
                m.worker
            )
        if js.done:
            del self.jobs[m.job_id]
        self.schedule()

    # -- eventual consistency -------------------------------------------------
    def on_heartbeat(self, lm_id: int, snapshot: list[bool]) -> None:
        base = lm_id * self.cfg.workers_per_lm
        cfg = self.cfg
        for g in range(cfg.num_gms):
            s = self.free[(g, lm_id)]
            for w in cfg.partition_workers(lm_id, g):
                if w in self.inflight:
                    continue  # don't clobber our own unverified placements
                if snapshot[w - base]:
                    s.add(w)
                else:
                    s.discard(w)
        if self.queue:
            # fresh state may reveal capacity for tasks waiting at this GM
            self.schedule()

    # -- recovery (§3.5): rebuild a fresh GM from LM snapshots ---------------
    def rebuild_from_heartbeats(self) -> None:
        for lm in self.sched.lms:
            self.on_heartbeat(lm.lm_id, lm.snapshot())


class Megha(Scheduler):
    name = "megha"

    def __init__(
        self, loop: EventLoop, metrics: RunMetrics, cfg: MeghaConfig
    ) -> None:
        super().__init__(loop, metrics)
        self.cfg = cfg
        self.lms = [LocalManager(l, cfg, self) for l in range(cfg.num_lms)]
        self.gms: list[Optional[GlobalManager]] = [
            GlobalManager(g, cfg, self) for g in range(cfg.num_gms)
        ]
        self._next_gm = 0
        self._hb_live: set[int] = set()
        self._ensure_heartbeats()

    def _active(self) -> bool:
        return any(gm is not None and (gm.jobs or gm.queue) for gm in self.gms)

    def _ensure_heartbeats(self) -> None:
        """Start the staggered periodic heartbeat trains; each self-quiesces
        when the DC goes idle so simulations terminate (restarted on submit)."""
        for i, lm in enumerate(self.lms):
            if i in self._hb_live:
                continue
            self._hb_live.add(i)
            offset = self.cfg.heartbeat_interval * (i + 1) / max(1, self.cfg.num_lms)
            self.loop.push(offset, lambda lm=lm: self._heartbeat(lm))

    def _heartbeat(self, lm: LocalManager) -> None:
        if not self._active():
            self._hb_live.discard(lm.lm_id)
            return
        lm.heartbeat()
        self.loop.push(self.cfg.heartbeat_interval, lambda: self._heartbeat(lm))

    def submit(self, job: Job) -> None:
        """Jobs are distributed evenly (round-robin) across GMs (§3.2);
        arrivals route past failed GMs to the next live one (§3.5) and only
        error out when the whole scheduling tier is down."""
        gm = None
        for _ in range(self.cfg.num_gms):
            gm = self.gms[self._next_gm]
            self._next_gm = (self._next_gm + 1) % self.cfg.num_gms
            if gm is not None:
                break
        if gm is None:
            raise RuntimeError(
                "no live GM to route job to; call recover_gm first"
            )
        self.loop.push(self.hop, lambda gm=gm, job=job: gm.on_job(job))
        self._ensure_heartbeats()

    # -- fault tolerance hooks (§3.5) -----------------------------------------
    def fail_gm(self, gm_id: int) -> list[Job]:
        """Kill a GM; returns the jobs that must be resubmitted elsewhere."""
        gm = self.gms[gm_id]
        assert gm is not None
        orphaned = [js.job for js in gm.jobs.values() if not js.done]
        self.gms[gm_id] = None
        return orphaned

    def recover_gm(self, gm_id: int) -> GlobalManager:
        """Start a fresh, stateless GM and rebuild its view from LM state."""
        gm = GlobalManager(gm_id, self.cfg, self)
        self.gms[gm_id] = gm
        gm.rebuild_from_heartbeats()
        return gm

    def fail_worker(self, worker: int) -> None:
        """Crash a worker; the LM restarts it and reruns the lost task."""
        lm = self.lms[self.cfg.lm_of(worker)]
        local = worker - lm.lm_id * self.cfg.workers_per_lm
        for gm_id, job_id, ti in lm.fail_worker(local):
            gm = self.gms[gm_id]
            if gm is None or job_id not in gm.jobs:
                continue
            js = gm.jobs[job_id]
            js.running -= 1
            js.task_records[ti].requeues += 1
            gm.queue.appendleft((job_id, ti))
            gm.schedule()
