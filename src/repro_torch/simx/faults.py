"""Round-space fault injection for the simx backend (paper §3.5, Fig. 4;
port of ``repro/simx/faults.py``).

The event backend injects faults imperatively (``fail_gm`` / ``recover_gm``
/ ``fail_worker`` callbacks on the loop); simx instead builds the fault
schedule into the round step: a ``FaultSchedule`` holds dense per-worker
and per-GM crash and recovery times that every round's step masks
against, so a fault study batches over a whole severity grid exactly like
a Fig. 2 load grid (``sweep.fig4_sweep``).

The crash transition itself runs as stage 1 of the shared round pipeline
(``runtime.fault_stage`` inside ``runtime.compose_step``), so every rule
inherits it; rules only supply their FIFO-head rollback from the returned
loss mask.  Semantics shared by every scheduler (megha, sparrow, eagle,
pigeon, oracle), as in the reference:

  * a worker is **down** during ``[worker_down, worker_up)``.  At the crash
    round its in-flight task (if any) is *lost*: the task returns to the
    pending pool (``task_finish`` reset to inf) and the owning queue's head
    pointer rolls back so the FIFO re-examines it; the ``lost`` counter
    increments.  While down the worker reads as busy-until-recovery
    (``worker_finish = worker_up``), so every scheduler's ground-truth
    free test excludes it with no extra masking, and megha's stale GM
    views keep proposing onto it until a heartbeat or piggyback repairs
    them.
  * ``worker_up == worker_down`` models the event backend's instant-restart
    ``fail_worker``; the restart lands at the next round boundary.
  * megha GMs are **down** during ``[gm_down, gm_up)``.  A down GM stops
    matching; each round its queue is adopted by a live GM chosen
    round-robin by round index, which matches it against the adopter's own
    view.  On recovery the GM's view is reset from LM ground truth.
  * ``hb_extra_rounds`` stretches megha's heartbeat period; the other
    schedulers have no heartbeats.

The **empty schedule is a no-op by construction**: every fault transition
is a masked update whose mask is all false (or an identity gather) when
all fault times are ``inf``, so results are bitwise the fault-free ones.

**The point axis.**  Every ``FaultSchedule`` leaf may carry leading point
axes (``float32[B, W]``, ``int32[B]``: one schedule per grid point); the
helpers below take any leading axes on the schedule and on the round
clock ``t`` and broadcast them.  A single run's schedule has none.

``FaultPlan`` is the backend-neutral description: a list of worker
failures and GM outages in simulated seconds that either becomes a
``FaultSchedule`` (simx) or installs the hooks on the event loop (events
backend), giving ``run_simulation(..., faults=...)`` one fault API across
both backends.  Schedules are built in numpy and converted at the end, so
the same plan or seed gives the reference's schedule bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.simx.state import spec


@dataclass(frozen=True)
class FaultSchedule:
    """Dense fault schedule (all times in simulated seconds; inf = never).

    Each leaf may carry a leading point axis (one schedule per grid
    point); ``simulate_fixed`` then runs that many points."""

    worker_down: torch.Tensor = spec("float32[W]")  # crash time
    worker_up: torch.Tensor = spec("float32[W]")    # recovery time (>= down)
    gm_down: torch.Tensor = spec("float32[G]")  # GM down-window start (megha)
    gm_up: torch.Tensor = spec("float32[G]")    # GM down-window end
    hb_extra_rounds: torch.Tensor = spec("int32[]")  # heartbeat-delay
                                # perturbation, rounds added to the period

    def replace(self, **kw) -> "FaultSchedule":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "FaultSchedule":
        """The schedule on ``device`` (each leaf moved; no copy when it is
        there already)."""
        return FaultSchedule(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })

    @property
    def batch(self) -> int | None:
        """The schedule's point axis (None for one run's schedule)."""
        return self.worker_down.shape[0] if self.worker_down.dim() == 2 else None


def _schedule(down, up, gdown, gup, hb_extra, device) -> FaultSchedule:
    """A ``FaultSchedule`` from numpy arrays, on ``device`` (None: the CPU)."""
    return FaultSchedule(
        worker_down=torch.from_numpy(down).to(device),
        worker_up=torch.from_numpy(up).to(device),
        gm_down=torch.from_numpy(gdown).to(device),
        gm_up=torch.from_numpy(gup).to(device),
        hb_extra_rounds=torch.from_numpy(np.asarray(hb_extra, np.int32)).to(device),
    )


def empty_schedule(num_workers: int, num_gms: int = 8, device=None) -> FaultSchedule:
    """The no-op schedule: nothing ever fails (bitwise the fault-free run).
    ``device=None`` builds it on the CPU, as torch's factories do; the
    steps move a schedule onto their run's device."""
    inf_w = np.full(num_workers, np.inf, np.float32)
    inf_g = np.full(num_gms, np.inf, np.float32)
    return _schedule(inf_w, inf_w.copy(), inf_g, inf_g.copy(), 0, device)


def is_empty(fs: FaultSchedule) -> bool:
    """Host check: does this schedule inject nothing?"""
    return bool(
        torch.all(torch.isinf(fs.worker_down))
        and torch.all(torch.isinf(fs.gm_down))
        and torch.all(fs.hb_extra_rounds == 0)
    )


# ---------------------------------------------------------------------------
# masked transitions shared by every rule's step function
# ---------------------------------------------------------------------------


def worker_dead(fs: FaultSchedule, t: torch.Tensor) -> torch.Tensor:
    """bool[..., W] — down at round-start time ``t`` (``[...]``); instant
    restarts never are."""
    tt = t[..., None]
    return (fs.worker_down <= tt) & (tt < fs.worker_up)


def apply_worker_faults(
    fs: FaultSchedule,
    t: torch.Tensor,
    dt: float,
    task_finish: torch.Tensor,
    worker_finish: torch.Tensor,
    worker_task: torch.Tensor,
    num_tasks: int,
):
    """The round-start crash transition shared by every rule (stage 1 of
    ``runtime.compose_step``), over any leading point axes.

    Workers whose crash time fell inside the round window just ended lose
    their in-flight task (re-pended) and read busy until their recovery
    time.  Returns ``(task_finish, worker_finish, lost_w bool[..., W],
    n_lost int32[...])``.  The reference's dropped scatter of the lost
    tasks' ``inf`` writes the pad slot T, which is cut off; every write
    carries the same value, so repeats of the pad give one result on any
    device.  With an empty schedule every mask is false and the arrays
    come through bitwise."""
    tt = t[..., None]
    crashed = (fs.worker_down <= tt) & (fs.worker_down > tt - dt)      # bool[..., W]
    lost_w = crashed & (worker_finish > tt)
    lost_t = torch.where(lost_w, worker_task, num_tasks).to(torch.int64)  # T = none
    padded = torch.cat(
        [task_finish, task_finish.new_zeros(task_finish.shape[:-1] + (1,))], -1)
    task_finish = padded.scatter(-1, lost_t, float("inf"))[..., :num_tasks]
    worker_finish = torch.where(crashed, fs.worker_up, worker_finish)
    return task_finish, worker_finish, lost_w, torch.sum(lost_w, dim=-1, dtype=torch.int32)


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
    device.  Sparrow's and eagle's steps take the same set from
    ``kernels.queues.queue_scan``, in the pass that builds the pick's mask,
    for orphan rescue: a pending job with no live entry anywhere (every
    probed worker down, or every probe dropped on a full queue) may be
    served by any idle worker."""
    return ref.jobs_with_reservation_ref(resq, num_jobs, dead)


def gm_down_mask(fs: FaultSchedule, t: torch.Tensor) -> torch.Tensor:
    """bool[..., G] — GMs inside their down window at time ``t``."""
    tt = t[..., None]
    return (fs.gm_down <= tt) & (tt < fs.gm_up)


def gm_recovered_now(fs: FaultSchedule, t: torch.Tensor, dt: float) -> torch.Tensor:
    """bool[..., G] — GMs whose recovery time fell in the round just ended."""
    tt = t[..., None]
    return (fs.gm_up <= tt) & (fs.gm_up > tt - dt)


def gm_adoption(down: torch.Tensor, rnd: torch.Tensor):
    """Round-robin adoption map for down GMs, per point.

    ``down`` is bool[..., G] and ``rnd`` int32[...].  Returns ``(adopt
    int32[..., G], row_active bool[..., G], n_live int32[...])``:
    ``adopt[g]`` is ``g`` for live GMs and, for down GMs, the live GM
    (rotating with the round index) that matches g's queue this round
    against its own view; ``row_active`` is false only when no GM is live
    (everything freezes); ``n_live`` is the live-GM count.  With no down
    GMs ``adopt`` is the identity.  The reference's dropped scatter of the
    live ranks writes the down GMs into the pad slot G, which is cut off
    (the live ranks are distinct)."""
    G = down.shape[-1]
    alive = ~down
    g_idx = torch.arange(G, dtype=torch.int32, device=down.device).expand(down.shape)
    n_live = torch.sum(alive, dim=-1, dtype=torch.int32)
    rank = torch.cumsum(alive, dim=-1, dtype=torch.int32) - 1        # live rank where alive
    live_of = torch.zeros(down.shape[:-1] + (G + 1,), dtype=torch.int32,
                          device=down.device).scatter(
        -1, torch.where(alive, rank, G).to(torch.int64), g_idx)[..., :G]  # live rank -> GM id
    pick = (g_idx + rnd[..., None]) % torch.clamp(n_live, min=1)[..., None]
    adopt = torch.where(alive, g_idx, torch.gather(live_of, -1, pick.to(torch.int64)))
    return adopt, alive | (n_live > 0)[..., None], n_live


# ---------------------------------------------------------------------------
# backend-neutral fault plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkerFailure:
    """One worker crash.  ``recover=None`` means instant restart (the event
    backend's only mode: the LM restarts the worker, the task re-runs)."""

    worker: int
    time: float
    recover: Optional[float] = None


@dataclass(frozen=True)
class GmOutage:
    """One megha GM down-window ``[time, recover)`` (§3.5)."""

    gm: int
    time: float
    recover: float


@dataclass(frozen=True)
class FaultPlan:
    """Backend-neutral fault description for ``run_simulation(faults=...)``.

    Becomes a dense ``FaultSchedule`` for simx (``to_schedule``) or
    installs the hooks on the event loop (``install_events``).  The error
    messages are the reference's, word for word."""

    worker_failures: tuple[WorkerFailure, ...] = ()
    gm_outages: tuple[GmOutage, ...] = ()
    heartbeat_delay: float = 0.0  # seconds added to megha's heartbeat period

    def _validate(self) -> None:
        """Shared plan validation (both backends fail fast alike): one
        failure per worker and one outage per GM (the dense schedule holds
        a single window per entity), and recovery not before the failure."""
        workers = [wf.worker for wf in self.worker_failures]
        if len(set(workers)) != len(workers):
            raise ValueError(
                "duplicate worker in FaultPlan: the dense schedule holds "
                "one crash window per worker"
            )
        gms = [go.gm for go in self.gm_outages]
        if len(set(gms)) != len(gms):
            raise ValueError(
                "duplicate GM in FaultPlan: the dense schedule holds one "
                "down window per GM"
            )
        for wf in self.worker_failures:
            if wf.recover is not None and wf.recover < wf.time:
                raise ValueError(f"worker {wf.worker}: recover before crash")
        for go in self.gm_outages:
            if go.recover < go.time:
                raise ValueError(f"gm {go.gm}: recover before failure")

    def to_schedule(
        self, num_workers: int, num_gms: int, dt: float, device=None
    ) -> FaultSchedule:
        """The plan as a dense schedule on ``device`` (None: the CPU)."""
        self._validate()
        down = np.full(num_workers, np.inf, np.float32)
        up = np.full(num_workers, np.inf, np.float32)
        for wf in self.worker_failures:
            if not (0 <= wf.worker < num_workers):
                raise ValueError(f"worker {wf.worker} outside [0, {num_workers})")
            down[wf.worker] = wf.time
            up[wf.worker] = wf.time if wf.recover is None else wf.recover
        gdown = np.full(num_gms, np.inf, np.float32)
        gup = np.full(num_gms, np.inf, np.float32)
        for go in self.gm_outages:
            if not (0 <= go.gm < num_gms):
                raise ValueError(f"gm {go.gm} outside [0, {num_gms})")
            gdown[go.gm] = go.time
            gup[go.gm] = go.recover
        return _schedule(down, up, gdown, gup,
                         max(0, round(self.heartbeat_delay / dt)), device)

    def install_events(self, sched, loop) -> None:
        """Install this plan as event-backend fault hooks.

        Only megha implements the paper's fault hooks; worker down-windows
        and heartbeat perturbation have no event-backend counterpart and
        must run on simx."""
        self._validate()
        cfg = getattr(sched, "cfg", None)
        if cfg is not None:
            for wf in self.worker_failures:
                nw = getattr(cfg, "num_workers", None)
                if nw is not None and not (0 <= wf.worker < nw):
                    raise ValueError(f"worker {wf.worker} outside [0, {nw})")
            for go in self.gm_outages:
                ng = getattr(cfg, "num_gms", None)
                if ng is not None and not (0 <= go.gm < ng):
                    raise ValueError(f"gm {go.gm} outside [0, {ng})")
        if self.heartbeat_delay:
            raise ValueError(
                "heartbeat_delay perturbation requires backend='simx' "
                "(the event backend's interval is a config constant)"
            )
        if self.worker_failures and not hasattr(sched, "fail_worker"):
            raise ValueError(
                f"scheduler {sched.name!r} has no fault hooks; fault "
                "injection on the events backend requires megha "
                "(use backend='simx' for the baselines)"
            )
        if self.gm_outages and not hasattr(sched, "fail_gm"):
            raise ValueError(
                f"scheduler {sched.name!r} has no GMs; gm_outages apply "
                "to megha only"
            )
        for wf in self.worker_failures:
            if wf.recover is not None and wf.recover > wf.time:
                raise ValueError(
                    "worker down-windows require backend='simx' (the event "
                    "backend restarts crashed workers instantly)"
                )
            loop.push_at(wf.time, lambda w=wf.worker: sched.fail_worker(w))
        for go in self.gm_outages:

            def _fail(go=go):
                orphaned = sched.fail_gm(go.gm)
                loop.push_at(go.recover, lambda g=go.gm: sched.recover_gm(g))
                # §3.5 availability contract: orphaned jobs resubmit and are
                # rerouted round-robin to the live GMs.
                for job in orphaned:
                    sched.submit(job)

            loop.push_at(go.time, _fail)


def fault_grid_schedule(
    num_workers: int,
    num_gms: int,
    fractions: Sequence[float],
    *,
    fail_time: float,
    outage: float,
    gm_outages: int = 0,
    dt: float = 0.05,
    heartbeat_delay: float = 0.0,
    seed: int = 0,
    device=None,
) -> FaultSchedule:
    """A severity grid as ONE batched schedule (leading axis = fraction), on
    ``device`` (None: the CPU).

    Point ``i`` crashes ``round(fractions[i] * num_workers)`` workers (a
    fixed seeded permutation, so higher severities kill supersets) at
    ``fail_time``, down for ``outage`` seconds.  Every nonzero-severity
    point additionally takes ``gm_outages`` GMs (megha only; capped to
    keep one live) down over the same window.  The reference's numpy code,
    line for line, so a seed gives its schedule bit for bit."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_workers)
    gperm = rng.permutation(num_gms)
    F = len(fractions)
    down = np.full((F, num_workers), np.inf, np.float32)
    up = np.full((F, num_workers), np.inf, np.float32)
    gdown = np.full((F, num_gms), np.inf, np.float32)
    gup = np.full((F, num_gms), np.inf, np.float32)
    for i, f in enumerate(fractions):
        if not (0.0 <= f < 1.0):
            raise ValueError("fault fractions must lie in [0, 1)")
        k = int(round(f * num_workers))
        down[i, perm[:k]] = fail_time
        up[i, perm[:k]] = fail_time + outage
        if f > 0.0 and gm_outages:
            g = min(gm_outages, num_gms - 1)  # always keep one GM live
            gdown[i, gperm[:g]] = fail_time
            gup[i, gperm[:g]] = fail_time + outage
    return _schedule(down, up, gdown, gup,
                     np.full(F, max(0, round(heartbeat_delay / dt)), np.int32), device)
