"""Simulation harness: drive a scheduler over a workload (paper §4.1).

Port of ``repro/sim/simulator.py``'s ``make_scheduler`` and
``run_simulation``, with the same signature and defaults.  Two backends:

  * ``backend="events"`` (the default): the discrete-event simulation of
    ``repro_torch.core``, pure Python on the host; megha so far.
  * ``backend="simx"``: the vectorized backend (megha and the oracle, on
    the CUDA card unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.base import Scheduler, grid_workers
from repro_torch.core.events import EventLoop
from repro_torch.core.megha import Megha, MeghaConfig
from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Workload


def make_scheduler(
    name: str,
    loop: EventLoop,
    metrics: RunMetrics,
    num_workers: int,
    **kwargs,
) -> Scheduler:
    """The event-backend scheduler ``name`` on ``loop``."""
    name = name.lower()
    if name == "megha":
        gms = kwargs.pop("num_gms", 8)
        lms = kwargs.pop("num_lms", 8)
        cfg = MeghaConfig(
            num_workers=grid_workers(num_workers, gms, lms),
            num_gms=gms,
            num_lms=lms,
            **kwargs,
        )
        return Megha(loop, metrics, cfg)
    if name in ("sparrow", "eagle", "pigeon"):
        raise NotImplementedError(
            f"the event backend's {name} is not ported yet (ROADMAP.md "
            "queue 1, items 8-9)"
        )
    raise ValueError(f"unknown scheduler {name!r}")


def run_simulation(
    scheduler: str,
    workload: Workload,
    num_workers: int,
    max_events: Optional[int] = None,
    until: Optional[float] = None,
    hooks: Optional[Callable] = None,
    backend: str = "events",
    faults=None,
    **kwargs,
) -> RunMetrics:
    """Run one (scheduler, workload) simulation to completion.

    ``backend="events"`` drives ``make_scheduler(scheduler, ...)`` (megha;
    kwargs ``num_gms``, ``num_lms``, ``heartbeat_interval``,
    ``batch_limit``, ``seed``) on an ``EventLoop``; ``hooks(sched, loop)``
    may inject imperative events before the loop drains.

    ``backend="simx"`` runs ``repro_torch.simx.simulate_workload`` with the
    scheduler kwargs (``num_gms``, ``num_lms``, ``heartbeat_interval``,
    ``dt``, ``seed``, ``chunk``, ``use_kernel``, ``orders``, ``device``)
    and returns its ``RunMetrics``."""
    if backend not in ("events", "simx"):
        raise ValueError(f"unknown backend {backend!r}")
    if faults is not None:
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP.md queue 1, item 7)"
        )
    if backend == "events":
        loop = EventLoop()
        metrics = RunMetrics(scheduler=scheduler, workload=workload.name)
        sched = make_scheduler(scheduler, loop, metrics, num_workers, **kwargs)
        for job in workload.sorted_jobs():
            loop.push_at(job.submit_time, lambda j=job: sched.submit(j))
        if hooks is not None:
            hooks(sched, loop)
        loop.run(until=until, max_events=max_events)
        return metrics
    if hooks is not None:
        raise ValueError("imperative hooks require backend='events'")
    if max_events is not None:
        raise ValueError("max_events is event-backend-only; use until")
    from repro_torch.simx import simulate_workload

    run = simulate_workload(scheduler, workload, num_workers, until=until, **kwargs)
    return run.to_run_metrics()
