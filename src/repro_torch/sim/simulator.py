"""Simulation harness: drive a scheduler over a workload (paper §4.1).

Port of ``repro/sim/simulator.py``'s ``make_scheduler`` and
``run_simulation``, with the same signature and defaults.  Two backends:

  * ``backend="events"`` (the default): the discrete-event simulation of
    ``repro_torch.core``, pure Python on the host: megha, sparrow, eagle
    and pigeon (``repro_torch.core.megha`` and ``core.baselines``).
  * ``backend="simx"``: the vectorized backend, on the CUDA card unless
    ``device="cpu"``: the same four schedulers plus the omniscient-oracle
    lower bound (``repro_torch.simx``).
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.base import Scheduler, grid_workers
from repro_torch.core.baselines import (
    Eagle,
    EagleConfig,
    Pigeon,
    PigeonConfig,
    Sparrow,
    SparrowConfig,
)
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
    if name == "sparrow":
        return Sparrow(loop, metrics, SparrowConfig(num_workers=num_workers, **kwargs))
    if name == "eagle":
        return Eagle(loop, metrics, EagleConfig(num_workers=num_workers, **kwargs))
    if name == "pigeon":
        return Pigeon(loop, metrics, PigeonConfig(num_workers=num_workers, **kwargs))
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

    ``backend="events"`` drives ``make_scheduler(scheduler, ...)`` on an
    ``EventLoop``, with each scheduler's config fields as kwargs (megha:
    ``num_gms``, ``num_lms``, ``heartbeat_interval``, ``batch_limit``,
    ``seed``; sparrow, eagle and pigeon: the fields of ``SparrowConfig``,
    ``EagleConfig`` and ``PigeonConfig``); ``hooks(sched, loop)`` may
    inject imperative events before the loop drains.

    ``backend="simx"`` runs ``repro_torch.simx.simulate_workload`` for any
    of its five rules (megha, sparrow, eagle, pigeon, oracle) with its
    kwargs: megha's ``num_gms``, ``num_lms``, ``heartbeat_interval``;
    sparrow's and eagle's ``probe_ratio``, ``reserve_cap``,
    ``probe_window``; eagle's ``long_threshold``,
    ``short_partition_fraction``; pigeon's ``num_distributors``,
    ``group_size``, ``reserved_per_group``, ``weight``; and ``dt``,
    ``seed``, ``chunk``, ``max_rounds``, ``use_kernel``, the rule's
    ``draws`` (megha's ``orders``) and ``device``; it returns the run's
    ``RunMetrics``.

    ``faults`` injects faults on either backend: a
    ``repro_torch.simx.FaultPlan`` (worker failures and megha GM outages
    in simulated seconds) installs the ``fail_worker`` / ``fail_gm`` /
    ``recover_gm`` hooks on the event loop (megha only), after ``hooks``,
    or enters the simx round step, where a dense ``FaultSchedule`` is also
    accepted and worker down-windows and heartbeat delays exist."""
    if backend == "simx":
        if hooks is not None:
            raise ValueError(
                "imperative hooks require backend='events'; pass faults= "
                "(a FaultPlan / FaultSchedule) for simx fault injection"
            )
        if max_events is not None:
            raise ValueError("max_events is event-backend-only; use until")
        from repro_torch.simx import simulate_workload

        run = simulate_workload(
            scheduler, workload, num_workers, until=until, faults=faults, **kwargs
        )
        return run.to_run_metrics()
    if backend != "events":
        raise ValueError(f"unknown backend {backend!r}")
    if faults is not None and not hasattr(faults, "install_events"):
        raise ValueError(
            "the events backend takes a backend-neutral FaultPlan; dense "
            "FaultSchedules compile into the simx round step only"
        )
    loop = EventLoop()
    metrics = RunMetrics(scheduler=scheduler, workload=workload.name)
    sched = make_scheduler(scheduler, loop, metrics, num_workers, **kwargs)
    for job in workload.sorted_jobs():
        loop.push_at(job.submit_time, lambda j=job: sched.submit(j))
    if hooks is not None:
        hooks(sched, loop)
    if faults is not None:
        faults.install_events(sched, loop)
    loop.run(until=until, max_events=max_events)
    return metrics
