"""Streaming steady-state engine: open-loop arrivals over a trace window
(port of ``repro/simx/stream.py``).

Every other simx entry point runs a fixed, fully materialised trace until
it drains.  This module runs any registered rule against an open-loop
*arrival process* (``repro_torch.workload.synth``'s ``ArrivalProcess``
family) through a **ring-buffer trace window**:

  * The device only ever holds a window of ``window_jobs`` job slots and
    ``window_tasks`` task slots (plus one pad-job slot that owns the unused
    task slots, keeping tasks contiguous per job, as ``late_bind`` needs).
    Carried state is O(W + window), whatever the simulated span.
  * Between ``rounds_per_refill``-round segments the host **refills** the
    window: jobs whose every task finished retire (their exact delays are
    collected, and the segment absorbed them into the P² sketch on the
    device), the carried jobs compact to the front in submit order (task
    index order is FIFO order), and new arrivals are admitted into the
    freed slots with their original submit times (a job that waits for a
    slot accrues the wait as queueing delay, which is what makes overload
    observable).  Task and job indices shift, so the host remaps
    ``task_finish``, ``worker_task`` (retired -> sentinel), the
    reservation queues' job ids (retired -> empty), and recomputes every
    FIFO head as the launched prefix of its rebuilt window FIFO.
  * Each rule's window-dependent layout (megha's per-GM FIFOs, the
    sparrow/eagle probe edge lists, eagle's central long FIFO, pigeon's
    per-group class FIFOs) enters the step as tensors (the ``layout=``
    argument of the rule's ``build_step``) with static capacities.  The
    rule builds it (``Rule.stream_layout``) with the same layout builder
    its fixed path uses (``megha_layout``, ``pigeon_layout``,
    ``eagle_layout``, all on ``state.fifo_rows``).  Per-job
    random quantities (probe targets, SSS re-route rotations) are drawn on
    the host per *global* job id at admission with numpy, exactly as the
    reference draws them, so a carried job keeps them and the streamed
    sparrow and eagle are bitwise the reference's streamed runs.

Within a window the round dynamics are exactly the fixed path's.

**What differs from the reference.**  PyTorch runs eagerly, so there is
no compiled segment to memoise (the reference's ``lru_cache`` of one
``jax.jit`` per rule and config): the step is rebuilt at every refill from
the new window's tensors and layout, which costs no host read and a few
small device ops (with a layout given, the step reads nothing of the
trace to the host).  The state carries the port's leading point axis (B = 1)
throughout, and the sketch a lane axis of one (``_segment_core`` also runs
the sharded steady state's L lanes).
The round loop reads nothing to the host inside a segment; a refill reads
the scalars it needs (clock, losses, gauges, sketch quantiles) in one host
read, then the arrays the remap needs.  Pigeon's FIFO rows are as wide as
one group can fill (``window_tasks // groups + window_jobs``, capped at
``window_tasks``) rather than the reference's ``window_tasks``: the rows'
width is a capacity, no result depends on it, and at 50,000 workers the
reference's width is 1,250 x 196,608 slots per class.  The step takes one
``match_fn`` (the port has no ``pick_fn``), and the sketch absorb runs the
``p2_sketch`` kernel when ``use_kernel``.

Reporting is streaming too: per-job delays feed the P² sketch
(``telemetry.QuantileSketch``) on the device, plus windowed utilisation /
pending gauges sampled at every refill.  ``run_steady_state`` returns a
``SteadyRun`` with the sketch quantiles, the gauge series, per-refill
conservation stats, and the measured carried-state bytes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.base import grid_workers
from repro_torch.device import resolve_device
from repro_torch.kernels import p2
from repro_torch.simx import runtime as rt
from repro_torch.simx import sparrow as _sparrow
from repro_torch.simx import telemetry as tlm
from repro_torch.simx.provenance import COMPONENTS, UNSET, Provenance, init_provenance
from repro_torch.simx.state import SimxConfig, TaskArrays
from repro_torch.workload.synth import ArrivalProcess
from repro_torch.workload.traces import Job


@dataclass
class _WinJob:
    """One admitted job riding in the window (host bookkeeping)."""

    gid: int                  # global job id (stream-wide, admission order)
    submit: float
    durations: np.ndarray     # float32[n]
    est: float
    ideal: float
    # rule extras, drawn once at admission from the (seed, gid) stream:
    targets: Optional[np.ndarray] = None   # int32[k] probe targets
    off1: int = 0                          # eagle SSS re-route rotations
    off2: int = 0
    groups: Optional[np.ndarray] = None    # int32[n] pigeon task -> group

    @property
    def ntasks(self) -> int:
        return int(self.durations.size)


def _prefix_rows(rows: np.ndarray, lens: np.ndarray, tf: np.ndarray) -> np.ndarray:
    """int32 per row: the launched prefix of each window FIFO row (the
    reference's ``_prefix``, over all rows at once) — where its head
    restarts.  ``rows [N, L]`` of task ids (the sentinel past each row's
    ``lens``), ``tf`` the remapped finish times."""
    n = int(lens.max(initial=0))
    if n == 0:
        return np.zeros(rows.shape[0], np.int32)
    ids = rows[:, :n]
    tf_pad = np.append(tf, np.float32(np.inf))
    col = np.arange(n)[None, :]
    holes = np.isinf(tf_pad[np.minimum(ids, tf.size)]) & (col < lens[:, None])
    return np.where(holes.any(axis=1), holes.argmax(axis=1), lens).astype(np.int32)


class _StreamWindow:
    """Host side of the ring buffer: admission, retirement, compaction,
    the rule's layout (``Rule.stream_layout``) and FIFO-head recomputation."""

    def __init__(
        self,
        arrivals: ArrivalProcess,
        cfg: SimxConfig,
        rule: str,
        window_jobs: int,
        window_tasks: int,
        seed: int,
        device: torch.device,
        provenance: bool = False,
        breakdown_bins: int = 32,
        breakdown_max: float = 60.0,
    ):
        if window_jobs < 1 or window_tasks < 1:
            raise ValueError("window capacities must be positive")
        self.cfg = cfg
        self.rule = rule
        self._rule = rt.get_rule(rule)
        self.device = device
        self.window_jobs = int(window_jobs)        # real job slots
        self.J_cap = int(window_jobs) + 1          # + the pad-job slot
        self.T_cap = int(window_tasks)
        self.seed = int(seed)
        self.jobs: list[_WinJob] = []
        self._it: Iterator[Job] = arrivals.jobs()
        self._next: Optional[Job] = None           # pulled but unadmitted
        self.exhausted = False
        # pigeon's persistent per-distributor round-robin counters
        self._rr = np.zeros(cfg.num_distributors, np.int64)
        # cumulative stream accounting
        self.jobs_admitted = 0
        self.tasks_admitted = 0
        self.jobs_retired = 0
        self.tasks_retired = 0
        self.retired_delays: list[float] = []
        self._last_t = 0.0  # previous refill boundary (busy accounting)
        # harvest-at-retirement delay decomposition: bounded host state,
        # a per-component histogram and running sums, no per-job storage
        self.provenance = bool(provenance)
        if provenance:
            self.breakdown_bins = int(breakdown_bins)
            self.breakdown_max = float(breakdown_max)
            self.prov_hist = {c: np.zeros(self.breakdown_bins, np.int64) for c in COMPONENTS}
            self.prov_sum = {c: 0.0 for c in COMPONENTS}
            self.prov_jobs = 0
        self.admit(float("-inf"))
        self._export()

    # -- admission -------------------------------------------------------

    def _admit_one(self, job: Job) -> None:
        cfg = self.cfg
        wj = _WinJob(
            gid=self.jobs_admitted,
            submit=float(job.submit_time),
            durations=np.asarray(job.durations, np.float32),
            est=float(job.estimated_duration),
            ideal=float(job.ideal_jct),
        )
        n = wj.ntasks
        if self.rule in ("sparrow", "eagle"):
            rng = np.random.default_rng((self.seed, 7, wj.gid))
            k = min(cfg.probe_ratio * n, cfg.num_workers)
            if self.rule == "eagle":
                if wj.est >= cfg.long_threshold:
                    k = 0
                wj.off1 = int(rng.integers(cfg.num_workers))
                wj.off2 = int(rng.integers(max(cfg.short_reserved, 1)))
            wj.targets = rng.choice(cfg.num_workers, size=k, replace=False).astype(np.int32)
        elif self.rule == "pigeon":
            d = wj.gid % cfg.num_distributors
            wj.groups = ((self._rr[d] + np.arange(n)) % cfg.num_groups).astype(np.int32)
            self._rr[d] += n
        self.jobs.append(wj)
        self.jobs_admitted += 1
        self.tasks_admitted += n

    def admit(self, t: float) -> None:
        """Pull arrivals into free window capacity (eagerly: a job whose
        submit lies in the future just sits unarrived in its slot)."""
        del t  # admission is capacity-bound, not time-bound
        used = sum(wj.ntasks for wj in self.jobs)
        while True:
            if self._next is None:
                if self.exhausted:
                    return
                try:
                    self._next = next(self._it)
                except StopIteration:
                    self.exhausted = True
                    return
            n = self._next.num_tasks
            if n > self.T_cap:
                raise ValueError(f"job with {n} tasks exceeds window_tasks={self.T_cap}")
            if len(self.jobs) >= self.window_jobs or used + n > self.T_cap:
                return
            self._admit_one(self._next)
            used += n
            self._next = None

    @property
    def drained(self) -> bool:
        return self.exhausted and self._next is None and not self.jobs

    @property
    def next_submit(self) -> float:
        """Submit time of the first unadmitted arrival (inf when none is
        waiting): ``t - next_submit > 0`` means admission is backlogged."""
        return float("inf") if self._next is None else float(self._next.submit_time)

    # -- window export ---------------------------------------------------

    def _export(self) -> None:
        """Rebuild the window's task arrays and rule layout (host numpy,
        then the layout's tensors on the device)."""
        J_cap, T_cap = self.J_cap, self.T_cap
        job = np.full(T_cap, J_cap - 1, np.int32)
        dur = np.zeros(T_cap, np.float32)
        sub = np.full(T_cap, np.inf, np.float32)
        job_sub = np.full(J_cap, np.inf, np.float32)
        job_ideal = np.zeros(J_cap, np.float32)
        job_nt = np.zeros(J_cap, np.int32)
        job_est = np.zeros(J_cap, np.float32)
        starts = np.zeros(len(self.jobs), np.int32)
        k = 0
        for p, wj in enumerate(self.jobs):
            n = wj.ntasks
            starts[p] = k
            job[k : k + n] = p
            dur[k : k + n] = wj.durations
            sub[k : k + n] = wj.submit
            job_sub[p] = wj.submit
            job_ideal[p] = wj.ideal
            job_nt[p] = n
            job_est[p] = wj.est
            k += n
        job_nt[J_cap - 1] = T_cap - k   # the pad job owns the spare slots
        self.T_real = k
        self.starts = starts
        self._np = dict(
            job=job, duration=dur, submit=sub, job_submit=job_sub,
            job_ideal=job_ideal, job_ntasks=job_nt, job_est=job_est,
        )
        self._build_layout()

    def tasks(self) -> TaskArrays:
        return TaskArrays(**{k: torch.from_numpy(v).to(self.device) for k, v in self._np.items()})

    # -- the rule's layout -----------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def per_task(self, per_job: np.ndarray, fill) -> np.ndarray:
        """A per-window-job value spread over the job's tasks (``fill`` on
        the spare slots)."""
        out = np.full(self.T_cap, fill, per_job.dtype)
        if self.jobs:
            out[: self.T_real] = np.repeat(per_job, [wj.ntasks for wj in self.jobs])
        return out

    def probe_layout(self) -> _sparrow.ProbeLayout:
        """Flat edge list over the window's real jobs (admission-order
        targets), padded to the static ``P_cap + C`` capacity."""
        cfg = self.cfg
        P_cap = cfg.probe_ratio * self.T_cap
        C = cfg.insert_window(P_cap, 0)
        ks = np.array([wj.targets.size for wj in self.jobs], np.int64)
        ends = np.zeros(self.J_cap, np.int32)
        ends[: ks.size] = np.cumsum(ks)
        p = int(ks.sum())
        ends[ks.size :] = p   # empty slots + the pad job: no edges
        edge_job = np.full(P_cap + C, self.J_cap, np.int32)
        edge_worker = np.zeros(P_cap + C, np.int32)
        if p:
            edge_job[:p] = np.repeat(np.arange(ks.size, dtype=np.int32), ks)
            edge_worker[:p] = np.concatenate([wj.targets for wj in self.jobs])
        self._edge_start = (ends[: ks.size] - ks).astype(np.int64)
        return _sparrow.ProbeLayout(
            edge_job=self._dev(edge_job), edge_worker=self._dev(edge_worker),
            edge_end=self._dev(ends), window=C,
        )

    def _build_layout(self) -> None:
        """The rule's layout of the window and the host FIFO rows whose
        heads a refill recomputes (``Rule.stream_layout``)."""
        if self._rule.stream_layout is None:  # pragma: no cover
            raise ValueError(f"no streaming layout for rule {self.rule!r}")
        self._layout, self._fifos = self._rule.stream_layout(self.cfg, self)

    def layout(self):
        return self._layout

    # -- refill ----------------------------------------------------------

    def _harvest(self, wj: _WinJob, sl: slice, tf: np.ndarray, pv: dict) -> None:
        """Decompose one retiring job's delay and fold it into the bounded
        per-component histograms: the host mirror of
        ``provenance.decompose_delays`` for a single finished job, run at
        the only moment its lifecycle rows are about to leave the window.
        ``pv`` is the provenance arrays as host numpy."""
        dt = self.cfg.dt
        tf_sl = tf[sl]
        jf = float(tf_sl.max())
        d = jf - wj.submit - wj.ideal
        # critical task: highest index achieving the job finish
        ci = int(sl.start) + int(np.nonzero(tf_sl == tf_sl.max())[0].max())
        start = float(tf[ci]) - float(self._np["duration"][ci])
        attempt_t = float(pv["first_attempt_round"][ci]) * dt
        anchor = np.clip(attempt_t, wj.submit, max(start, wj.submit))
        eligible = float(np.clip(anchor - wj.submit, 0.0, d))
        retry = float(np.clip(float(pv["stale_retry_count"][ci]) * dt, 0.0, d - eligible))
        rework = float(np.clip(
            float(pv["launch_round"][ci] - pv["first_launch_round"][ci]) * dt,
            0.0, d - eligible - retry,
        ))
        comps = {
            "eligible_wait": eligible,
            "placement_wait": d - (eligible + retry + rework),
            "inconsistency_retry": retry,
            "fault_rework": rework,
        }
        width = self.breakdown_max / self.breakdown_bins
        for c, v in comps.items():
            b = int(np.clip(v / width, 0, self.breakdown_bins - 1))
            self.prov_hist[c][b] += 1
            self.prov_sum[c] += v
        self.prov_jobs += 1

    def refill(self, state, t: float, lost: int, probe_head: int = 0,
               collect_delays: bool = True, prov=None):
        """Retire / compact / admit / remap between segments.

        ``state`` is the batched (B = 1) state after a segment, ``t``,
        ``lost`` and ``probe_head`` its scalars, already read to the host.
        Returns ``(state, stats, prov)``: ``state`` with every task/job
        index remapped to the new window and every FIFO head recomputed;
        ``stats`` the conservation counts at this boundary (taken before
        retirement, over the admitted stream so far); ``prov`` the remapped
        lifecycle arrays (None round-trips).  With ``prov``, each retiring
        job's delay decomposition is harvested first."""
        tf = state.task_finish[0].cpu().numpy()
        # -- conservation snapshot over the whole admitted stream ---------
        real = self._np["job"] < self.J_cap - 1
        done_mask = real & (tf <= t)
        run_mask = real & np.isfinite(tf) & (tf > t)
        pend_mask = real & np.isinf(tf) & (self._np["submit"] <= t)
        wait_mask = real & np.isinf(tf) & (self._np["submit"] > t)
        # exact busy-seconds this segment: durations of tasks that finished
        # in (last_t, t], each counted once
        seg_done = done_mask & (tf > self._last_t)
        stats = dict(
            t=t,
            span=t - self._last_t,
            admitted=self.tasks_admitted,
            completed=self.tasks_retired + int(done_mask.sum()),
            running=int(run_mask.sum()),
            pending=int(pend_mask.sum()),
            unarrived=int(wait_mask.sum()),
            lost=int(lost),
            window_jobs=len(self.jobs),
            busy=float(self._np["duration"][seg_done].sum()),
        )
        self._last_t = t
        # -- retire completed jobs, compact the carried ones --------------
        queues = self._rule.has_queues
        task_map = np.full(self.T_cap + 1, self.T_cap, np.int32)
        job_map = np.full(self.J_cap + 1, self.J_cap, np.int32)
        pv = None
        if prov is not None:
            fields = [f.name for f in dataclasses.fields(Provenance)]
            pv = {f: getattr(prov, f)[0].cpu().numpy() for f in fields}
        carried: list[_WinJob] = []
        new_probe_head = 0
        k = 0
        for p, wj in enumerate(self.jobs):
            n = wj.ntasks
            sl = slice(int(self.starts[p]), int(self.starts[p]) + n)
            if np.all(tf[sl] <= t):
                self.jobs_retired += 1
                self.tasks_retired += n
                if collect_delays:
                    self.retired_delays.append(float(tf[sl].max()) - wj.submit - wj.ideal)
                if pv is not None and self.provenance:
                    self._harvest(wj, sl, tf, pv)
                continue
            if queues:
                new_probe_head += int(np.clip(probe_head - self._edge_start[p], 0,
                                              wj.targets.size))
            job_map[p] = len(carried)
            task_map[sl] = np.arange(k, k + n, dtype=np.int32)
            carried.append(wj)
            k += n
        # carried tasks move to their new slots (kept order); the rest of
        # the window reads unlaunched, and its lifecycle rows unset
        keep = np.nonzero(task_map[: self.T_cap] < self.T_cap)[0]
        new_tf = np.full(self.T_cap, np.inf, np.float32)
        new_tf[task_map[keep]] = tf[keep]
        self.jobs = carried
        self.admit(t)
        self._export()
        # -- remap the carried device state -------------------------------
        dev = self.device
        wt = state.worker_task[0].cpu().numpy()
        upd = dict(
            task_finish=self._dev(new_tf)[None],
            worker_task=self._dev(task_map[wt])[None],
        )
        if queues:
            resq = state.resq[0].cpu().numpy()
            upd["resq"] = self._dev(job_map[resq])[None]
            upd["probe_head"] = torch.tensor([new_probe_head], dtype=torch.int32, device=dev)
        # every FIFO head restarts at the launched prefix of its new row
        for field, fifo in self._fifos.items():
            head = _prefix_rows(fifo.rows, fifo.lens, new_tf)
            upd[field] = self._dev(head).reshape(getattr(state, field).shape)
        if prov is not None:
            remapped = {}
            for f, v in pv.items():
                unset = 0 if f in ("requeue_count", "stale_retry_count") else UNSET
                out = np.full(self.T_cap, unset, np.int32)
                out[task_map[keep]] = v[keep]
                remapped[f] = self._dev(out)[None]
            prov = prov.replace(**remapped)
        return state.replace(**upd), stats, prov


# ---------------------------------------------------------------------------
# the segment
# ---------------------------------------------------------------------------


def _segment_core(rule: str, cfg: SimxConfig, num_rounds: int, match_fn, orders=None,
                  telemetry: Optional[tlm.TelemetryConfig] = None, stride: int = 1,
                  provenance: bool = False, absorb: Callable = tlm.sketch_absorb):
    """One ``num_rounds``-round advance ``seg(carry, win_tasks, layout,
    sketch)``: builds the rule's step from the window's tensors and layout,
    runs the rounds, absorbs the segment's completed-job delays into the
    sketch (``absorb``: the ``p2_sketch`` kernel or its plain version) and
    computes the gauges, all on the device.  Returns ``(carry, sketch,
    gauges, blocks, lane_borrow)``; ``blocks`` holds the telemetry
    windows' ``[B, K]`` series (empty without telemetry).

    The carry holds B lanes, one window each, and the sketch is
    lane-batched (``sketch_init(lanes=B)``): a single run is one lane on
    its window's own arrays, and several lanes (``_SteadyLoop``) stack
    their windows (every task and layout field ``[L, ...]``), so one
    absorb takes every lane's ``[B, J]`` delays.  The gauges are ``[B]``;
    ``lane_borrow`` (``int32[B]``, on the device) counts the rounds each
    lane ran megha's borrow pass in."""
    tele = telemetry is not None
    if tele and num_rounds % stride:
        raise ValueError("telemetry stride must divide rounds_per_refill")

    r = rt.get_rule(rule)
    draws = {} if orders is None else {"orders": orders}  # megha's GM orders

    def build_step(win_tasks, layout):
        return r.build_step(cfg, win_tasks, draws, match_fn=match_fn, telemetry=tele,
                            provenance=provenance, layout=layout)

    W = cfg.num_workers

    def seg(carry, win_tasks, layout, sketch):
        step = build_step(win_tasks, layout)
        if tele:
            sample_fn = tlm.default_sample_fn(cfg, win_tasks, None)
            carry, blocks = tlm.scan_blocks(step, carry, num_rounds // stride, stride, sample_fn)
        else:
            carry = rt.scan_rounds(step, carry, num_rounds)
            blocks = {}
        state = rt.carry_state(carry)
        # jobs completed THIS segment: every refill retires completed jobs,
        # so a finite delay here is new, absorbed exactly once
        delays, _ = rt.job_delays_from_state(state.task_finish, state.t, win_tasks)
        fin = torch.isfinite(delays)
        sketch = absorb(sketch, torch.where(fin, delays, 0.0), fin)
        t = state.t[:, None]
        tf = state.task_finish
        gauges = dict(
            utilization=torch.sum(state.worker_finish > t, dim=-1, dtype=torch.float32) / W,
            pending=torch.sum(torch.isinf(tf) & (win_tasks.submit <= t), dim=-1,
                              dtype=torch.int32),
            running=torch.sum(torch.isfinite(tf) & (tf > t), dim=-1, dtype=torch.int32),
        )
        # the rounds each lane borrowed in (megha; 0 for the others), on
        # the device: the caller reads them with its scalars
        lane_borrow = getattr(step, "point_borrow_rounds", None)
        if lane_borrow is None:
            lane_borrow = torch.zeros_like(state.rnd)
        return carry, sketch, gauges, blocks, lane_borrow

    return seg


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@dataclass
class SteadyRun:
    """A finished (or horizon-capped) streaming run."""

    rule: str
    cfg: SimxConfig
    quantile_targets: tuple
    quantile_estimates: np.ndarray   # float32[Q] — sketch estimates
    series: dict                     # per-refill gauge trajectories
    refills: list                    # per-boundary conservation stats
    delays: Optional[np.ndarray]     # exact retired-job delays (host)
    jobs_admitted: int
    jobs_completed: int
    tasks_admitted: int
    tasks_completed: int
    lost: int
    messages: int
    probes: int
    rounds: int
    end_time: float
    state_bytes: int                 # carried device state (O(W + window))
    timeline: Optional[tlm.Timeline] = None   # merged in-scan telemetry
    breakdown: Optional[dict] = None          # harvested delay decomposition
    borrow_rounds: int = 0           # megha's rounds that ran the borrow pass
    segment_seconds: float = 0.0     # host wall in segments (to their sync)
    refill_seconds: float = 0.0      # host wall in refills

    def quantile(self, q: float) -> float:
        """Sketch estimate for target quantile ``q`` (one of
        ``quantile_targets``)."""
        return float(self.quantile_estimates[self.quantile_targets.index(q)])

    @property
    def mean_utilization(self) -> float:
        """Exact time-averaged worker utilisation over the run: total busy
        resource-seconds (every completed task's duration, counted at its
        finishing segment) / (workers x simulated span)."""
        busy = sum(s["busy"] for s in self.refills)
        cap = self.cfg.num_workers * self.end_time
        return busy / cap if cap > 0 else 0.0


def stream_config(
    rule: str,
    num_workers: int,
    *,
    window_tasks: int,
    num_gms: int = 8,
    num_lms: int = 8,
    **kw,
) -> SimxConfig:
    """A ``SimxConfig`` for streaming: shave the worker count to the GM x
    LM grid for grid rules, and pin the auto-sized reservation-queue knobs
    (``reserve_cap`` / ``probe_window``) to window-derived values so queue
    shapes cannot drift between refills."""
    r = rt.get_rule(rule)
    if r.needs_grid:
        num_workers = grid_workers(num_workers, num_gms, num_lms)
    cfg = SimxConfig(num_workers=num_workers, num_gms=num_gms, num_lms=num_lms, **kw)
    if r.has_queues:
        p_cap = cfg.probe_ratio * int(window_tasks)
        if cfg.reserve_cap == 0:
            cfg = dataclasses.replace(cfg, reserve_cap=cfg.queue_cap(p_cap))
        if cfg.probe_window == 0:
            cfg = dataclasses.replace(cfg, probe_window=int(min(p_cap, max(256, p_cap // 32))))
    return cfg


def _leaves(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _leaves(v)


def state_nbytes(*trees) -> int:
    """Total bytes of the tensors (and numpy arrays) in the given
    dataclasses, dicts and tuples: the measured carried-state footprint the
    O(W + window) claim is held to."""
    return int(sum(
        leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.nbytes
        for tree in trees for leaf in _leaves(tree)
    ))




def _stack_tasks(wins: list, device: torch.device) -> TaskArrays:
    """The windows' task arrays stacked to ``[L, ...]`` on the host, one
    upload per field."""
    return TaskArrays(**{k: torch.from_numpy(np.stack([w._np[k] for w in wins])).to(device)
                         for k in wins[0]._np})


#: the scalars a segment leaves per lane, read to the host in one read
#: (with the sketch quantiles after them): the clock, losses, gauges,
#: borrow rounds, and the probe head (0 for the rules without queues)
_SCALARS = ("t", "lost", "utilization", "pending", "running", "borrow", "probe_head")


class _SteadyLoop:
    """The host loop of the streaming engine, over one lane
    (``run_steady_state``) or several (``shard.sharded_steady_state``):
    each lane's window, carry and sketch, the segment on each of
    ``devices`` (a lane-batched one when there are several lanes), and
    the per-lane records.  ``segment()`` advances every lane one segment
    and reads every lane's scalars in one host read, without touching the
    lanes' stored carries (so a segment can be run again from the same
    inputs); ``refill(seg)`` takes its results into the live lanes and
    refills their windows; ``runs()`` gives the finished ``SteadyRun``s.

    The lane count is padded to a multiple of ``len(devices)`` by
    repeating lane 0, and each device runs its contiguous slice of the
    lanes.  A lane that drains (or trips ``horizon`` / ``max_rounds``) is
    frozen: it keeps its place in the batch but takes no more results.
    One lane on one device runs on its window's own arrays; several stack
    their windows' task and layout fields to ``[L, ...]`` (the
    capacities come from the one shared config, so they stack).
    Telemetry and provenance take one lane, as in the reference."""

    def __init__(
        self,
        rule: str,
        arrivals: list,
        num_workers: int,
        *,
        devices,
        entry: str = "run_steady_state",
        cfg: Optional[SimxConfig] = None,
        window_jobs: int = 256,
        window_tasks: Optional[int] = None,
        rounds_per_refill: int = 64,
        horizon: Optional[float] = None,
        max_rounds: int = 2_000_000,
        quantiles: tuple = tlm.DEFAULT_QUANTILES,
        collect_delays: bool = True,
        match_fn: rt.MatchFn | None = None,
        use_kernel: bool = True,
        num_gms: int = 8,
        num_lms: int = 8,
        dt: float = 0.05,
        seed: int = 0,
        orders: torch.Tensor | None = None,
        draws: dict | None = None,
        telemetry: tlm.TelemetryConfig | bool | None = None,
        provenance: bool = False,
        breakdown_bins: int = 32,
        breakdown_max: float = 60.0,
        **cfg_kw,
    ):
        name = rule.lower()
        r = rt.get_rule(name)  # fail fast on unknown rules
        rt.check_round_budget(max_rounds, f"{entry}(max_rounds=...)")
        if horizon is not None:
            # the horizon is enforced in rounds via the int32 round clock, so
            # it shares the same overflow budget
            rt.check_round_budget(int(math.ceil(horizon / (dt if cfg is None else cfg.dt))),
                                  f"{entry}(horizon=...)")
        if not arrivals:
            raise ValueError(f"{entry} needs at least one lane")
        n_dev = len(devices)
        n_pad = -(-len(arrivals) // n_dev) * n_dev
        self.order = list(range(len(arrivals))) + [0] * (n_pad - len(arrivals))
        self.per = n_pad // n_dev
        if telemetry is True:
            telemetry = tlm.TelemetryConfig()
        if (telemetry is not None or provenance) and n_pad > 1:
            raise ValueError("telemetry and provenance take one lane on one device: "
                             "run them through run_steady_state")
        if window_tasks is None:
            window_tasks = window_jobs * 16
        if cfg is None:
            cfg = stream_config(name, num_workers, window_tasks=window_tasks,
                                num_gms=num_gms, num_lms=num_lms, dt=dt, **cfg_kw)
        stride = 1
        if telemetry is not None:
            stride = min(telemetry.stride, rounds_per_refill)
            while rounds_per_refill % stride:
                stride -= 1
        if match_fn is None:
            match_fn = rt.default_match_fn(use_kernel)
        self.name, self.cfg, self.devices = name, cfg, tuple(devices)
        self.home = resolve_device(devices[0])
        self.rounds_per_refill, self.horizon, self.max_rounds = (
            rounds_per_refill, horizon, max_rounds)
        self.quantiles, self.collect_delays = tuple(quantiles), collect_delays
        self.telemetry, self.stride, self.provenance = telemetry, stride, provenance
        self.queues = r.has_queues
        self.wins = [_StreamWindow(
            a, cfg, name, window_jobs, window_tasks, seed, self.home, provenance=provenance,
            breakdown_bins=breakdown_bins, breakdown_max=breakdown_max) for a in arrivals]
        megha_orders = None
        draws = rt.orders_as_draws(orders, draws)
        if name == "megha":
            megha_orders = rt.rule_draws(r, cfg, self.wins[0].tasks(),
                                         seed if draws is None else draws)["orders"]
        elif draws is not None:
            raise ValueError(f"{name} draws its per-job quantities at admission: pass no draws")
        self.carry = []
        for w in self.wins:
            state = rt.batch_state(r.init(cfg, w.tasks()))
            self.carry.append((state, init_provenance(w.T_cap, self.home, 1))
                              if provenance else state)
        self.sketch = [tlm.sketch_init(quantiles, device=self.home, lanes=1) for _ in self.wins]
        absorb = p2.p2_absorb if use_kernel else tlm.sketch_absorb
        self.segs = [_segment_core(
            name, cfg, rounds_per_refill, match_fn,
            None if megha_orders is None else megha_orders.to(d),
            telemetry=telemetry, stride=stride, provenance=provenance, absorb=absorb)
            for d in self.devices]
        keys = ("t", "utilization", "busy_util", "pending", "running", "window_jobs",
                "admission_lag")
        self.series = [{**{k: [] for k in keys}, **{f"q{q}": [] for q in quantiles}}
                       for _ in self.wins]
        self.refills: list[list] = [[] for _ in self.wins]
        self.blocks: list[list] = [[] for _ in self.wins]
        self.live = [True] * len(self.wins)
        self.rounds = [0] * len(self.wins)
        self.borrow = [0] * len(self.wins)
        self.seg_s = [0.0] * len(self.wins)
        self.refill_s = [0.0] * len(self.wins)

    @property
    def done(self) -> bool:
        return not any(self.live)

    def segment(self) -> dict:
        """One segment of every lane (pads and frozen lanes included) and
        the one host read of its scalars (``_SCALARS``, then the sketch
        quantiles: a row per lane)."""
        t0 = time.perf_counter()
        order = self.order
        if len(order) == 1:
            win = self.wins[order[0]]
            outs = [self.segs[0](self.carry[order[0]], win.tasks(), win.layout(),
                                 self.sketch[order[0]])]
        else:
            wins = [self.wins[i] for i in order]
            batch = (rt.tree_join(torch.cat, [self.carry[i] for i in order]),
                     _stack_tasks(wins, self.home),
                     rt.tree_join(torch.stack, [w.layout() for w in wins]),
                     rt.tree_join(torch.cat, [self.sketch[i] for i in order]))
            outs = [seg(*part) for seg, part in
                    zip(self.segs, rt.split_batch(batch, self.devices, self.per))]
        carry, sketch, gauges, blocks, borrow = rt.gather_batch(outs, self.home)
        state = rt.carry_state(carry)
        head = state.probe_head if self.queues else torch.zeros_like(state.lost)
        cols = torch.stack([state.t.double(), state.lost.double(),
                            gauges["utilization"].double(), gauges["pending"].double(),
                            gauges["running"].double(), borrow.double(), head.double()], dim=1)
        scal = torch.cat([cols, tlm.sketch_quantiles(sketch).double()], dim=1).cpu().numpy()
        return dict(carry=carry, state=state, sketch=sketch, blocks=blocks, scal=scal,
                    seconds=time.perf_counter() - t0)

    def refill(self, seg: dict) -> None:
        """Take a segment's results into every live lane and refill its
        window on the host."""
        cfg, k = self.cfg, len(_SCALARS)
        for i, win in enumerate(self.wins):
            if not self.live[i]:
                continue
            t0 = time.perf_counter()
            t_now, lost, util, pending, running, borrow, head = seg["scal"][i, :k]
            t_now = float(np.float32(t_now))
            carry = rt.tree_map(lambda x, i=i: x[i:i + 1], seg["carry"])
            self.sketch[i] = rt.tree_map(lambda x, i=i: x[i:i + 1], seg["sketch"])
            if self.telemetry is not None:
                self.blocks[i].append({key: v[i] for key, v in seg["blocks"].items()})
            self.rounds[i] += self.rounds_per_refill
            self.borrow[i] += int(borrow)
            lag = max(0.0, t_now - win.next_submit)
            state, prov = carry if self.provenance else (carry, None)
            state, stats, prov = win.refill(state, t_now, int(lost), int(head),
                                            collect_delays=self.collect_delays, prov=prov)
            self.carry[i] = (state, prov) if self.provenance else state
            self.refills[i].append(stats)
            s = self.series[i]
            s["t"].append(stats["t"])
            s["utilization"].append(float(np.float32(util)))
            s["busy_util"].append(stats["busy"] / (cfg.num_workers * stats["span"])
                                  if stats["span"] > 0 else 0.0)
            s["pending"].append(int(pending))
            s["running"].append(int(running))
            s["window_jobs"].append(stats["window_jobs"])
            s["admission_lag"].append(lag)
            for q, v in zip(self.quantiles, seg["scal"][i, k:]):
                s[f"q{q}"].append(float(np.float32(v)))
            if (win.drained or (self.horizon is not None and t_now >= self.horizon)
                    or self.rounds[i] >= self.max_rounds):
                self.live[i] = False
            self.seg_s[i] += seg["seconds"]
            self.refill_s[i] += time.perf_counter() - t0

    def _timeline(self, i: int) -> Optional[tlm.Timeline]:
        """Lane ``i``'s telemetry windows merged across its refills."""
        blocks, tel, win = self.blocks[i], self.telemetry, self.wins[i]
        if tel is None or not blocks:
            return None
        merged = {key: torch.cat([b[key] for b in blocks]) for key in blocks[0]}
        t_axis = merged.pop("t", torch.zeros(0, dtype=torch.float32, device=self.home))
        # streamed delay histogram: retired jobs live on the host, so the
        # exact delays (when collected) bin directly; otherwise empty
        hist = np.zeros(tel.delay_bins, np.int32)
        if self.collect_delays and win.retired_delays:
            b = np.clip((np.asarray(win.retired_delays) / tel.bin_width).astype(int),
                        0, tel.delay_bins - 1)
            hist = np.bincount(b, minlength=tel.delay_bins).astype(np.int32)
        return tlm.Timeline(
            t=t_axis, series=merged, delay_hist=torch.from_numpy(hist).to(self.home),
            stride=self.stride, dt=self.cfg.dt, delay_max=tel.delay_max,
        )

    def _breakdown(self, i: int) -> Optional[dict]:
        """Lane ``i``'s harvested delay decomposition."""
        if not self.provenance:
            return None
        win = self.wins[i]
        n = max(win.prov_jobs, 1)
        return {
            "jobs": win.prov_jobs,
            "bin_edges": np.linspace(0.0, win.breakdown_max, win.breakdown_bins + 1),
            "hist": {c: h.copy() for c, h in win.prov_hist.items()},
            "sum": dict(win.prov_sum),
            "mean": {c: s / n for c, s in win.prov_sum.items()},
        }

    def runs(self) -> list[SteadyRun]:
        """One ``SteadyRun`` per lane (pads dropped), in arrivals order."""
        states = [rt.carry_state(c) for c in self.carry]
        # every lane's final clock, counters and finish times: one host read
        end = torch.stack([torch.cat([st.task_finish[0].double(), torch.stack([
            st.t[0].double(), st.lost[0].double(), st.messages[0].double(),
            st.probes[0].double()])]) for st in states]).cpu().numpy()
        final_q = tlm.sketch_quantiles(rt.tree_join(torch.cat, self.sketch)).cpu().numpy()
        out = []
        for i, win in enumerate(self.wins):
            tf = end[i, : win.T_cap].astype(np.float32)
            t_end, lost, messages, probes = end[i, win.T_cap:]
            t_end = float(np.float32(t_end))
            in_window_done = int(np.sum((win._np["job"] < win.J_cap - 1) & (tf <= t_end)))
            out.append(SteadyRun(
                rule=self.name,
                cfg=self.cfg,
                quantile_targets=self.quantiles,
                quantile_estimates=final_q[i],
                series={k: np.asarray(v) for k, v in self.series[i].items()},
                refills=self.refills[i],
                delays=(np.asarray(win.retired_delays, np.float64)
                        if self.collect_delays else None),
                jobs_admitted=win.jobs_admitted,
                jobs_completed=win.jobs_retired,
                tasks_admitted=win.tasks_admitted,
                tasks_completed=win.tasks_retired + in_window_done,
                lost=int(lost),
                messages=int(messages),
                probes=int(probes),
                rounds=self.rounds[i],
                end_time=t_end,
                state_bytes=state_nbytes(states[i], win._np, win.layout(), self.sketch[i]),
                timeline=self._timeline(i),
                breakdown=self._breakdown(i),
                borrow_rounds=self.borrow[i],
                segment_seconds=self.seg_s[i],
                refill_seconds=self.refill_s[i],
            ))
        return out

    def run(self) -> list[SteadyRun]:
        """Segments and refills until every lane is done."""
        while not self.done:
            self.refill(self.segment())
        return self.runs()


def run_steady_state(
    rule: str,
    arrivals: ArrivalProcess,
    num_workers: int,
    *,
    device: str | torch.device | None = None,
    **kw,
) -> SteadyRun:
    """Stream ``arrivals`` through ``rule`` until the stream drains, the
    ``horizon`` (simulated seconds) passes, or ``max_rounds`` trips.

    Works for every registered rule, on ``device`` (None: the CUDA card,
    raising without one; tests pass ``"cpu"``).  Keywords (``_SteadyLoop``'s):
    ``window_jobs`` / ``window_tasks`` size the ring buffer (defaults: 256
    jobs, 16 tasks each); ``rounds_per_refill`` (64) is the segment length:
    the host reads the device only at refills, so longer segments amortise
    more but retire jobs (and admit backlogged arrivals) less promptly.
    ``horizon``, ``max_rounds`` (2,000,000), ``quantiles``, ``num_gms`` /
    ``num_lms`` (8), ``dt`` (0.05).  Extra keyword arguments land on
    ``SimxConfig``; pass a prebuilt ``cfg`` to bypass (its queue knobs must
    be pinned, see ``stream_config``).  ``seed`` (0) seeds the per-job probe
    targets and rotations (numpy, as the reference draws them) and, when
    megha's ``orders=`` / ``draws=`` are not given, a ``torch.Generator``
    for megha's GM orders (the reference draws those with ``jax.random``;
    parity runs feed them in).

    ``match_fn`` is every match of the rule (default: the kernel wrapper,
    or its plain version with ``use_kernel=False``); the sketch's
    per-segment absorb is the ``p2_sketch`` kernel's wrapper, or its plain
    version with ``use_kernel=False``.

    ``collect_delays=True`` keeps every retired job's exact delay on the
    host (O(completed jobs) host memory); switch it off for unbounded runs
    and read the sketch instead.  ``telemetry`` (a ``TelemetryConfig``, or
    ``True`` for the defaults) collects each segment's windows and merges
    them across refills into one ``Timeline`` on ``SteadyRun.timeline``;
    the stride is shrunk to the largest divisor of ``rounds_per_refill``.
    ``provenance=True`` carries the per-task lifecycle arrays through every
    segment (remapped at refill) and harvests each retiring job's delay
    decomposition into bounded per-component histograms
    (``breakdown_bins`` (32) x ``breakdown_max`` (60.0)) on
    ``SteadyRun.breakdown``."""
    (run,) = _SteadyLoop(rule, [arrivals], num_workers,
                         devices=(resolve_device(device),), **kw).run()
    return run
