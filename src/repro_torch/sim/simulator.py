"""Simulation harness: drive a scheduler over a workload (paper §4.1).

Port of ``repro/sim/simulator.py``'s ``run_simulation``, with the same
signature and defaults.  The port has the ``backend="simx"`` path (megha
and the oracle, on the CUDA card unless ``device="cpu"``); the event
backend is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.metrics import RunMetrics
from repro_torch.workload.traces import Workload


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

    ``backend="simx"`` runs ``repro_torch.simx.simulate_workload`` with the
    scheduler kwargs (``num_gms``, ``num_lms``, ``heartbeat_interval``,
    ``dt``, ``seed``, ``chunk``, ``use_kernel``, ``orders``, ``device``)
    and returns its ``RunMetrics``."""
    if backend == "events":
        raise NotImplementedError(
            "the event backend is not ported yet (ROADMAP.md queue 1, "
            "item 17); use backend='simx'"
        )
    if backend != "simx":
        raise ValueError(f"unknown backend {backend!r}")
    if hooks is not None:
        raise ValueError("imperative hooks require backend='events'")
    if max_events is not None:
        raise ValueError("max_events is event-backend-only; use until")
    if faults is not None:
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP.md queue 1, item 7)"
        )
    from repro_torch.simx import simulate_workload

    run = simulate_workload(scheduler, workload, num_workers, until=until, **kwargs)
    return run.to_run_metrics()
