"""The Fig. 2 and Fig. 4 sweeps: a whole (load x seed) or (fault severity
x seed) grid as one batched program (port of ``repro/simx/sweep.py``).

The paper's headline comparison sweeps scheduler x load at a fixed DC size
and reports p50/p95 job delay per point.  For the synthetic trace, load
only rescales inter-arrival times (same jobs, same tasks, same durations),
so every grid point shares one ``TaskArrays`` *structure* and differs only
in the ``submit`` / ``job_submit`` arrays (and in the random draws of its
seed: megha's GM orders, sparrow's and eagle's probe targets and eagle's
re-route rotations):

    grid = sweep_grid("megha", cfg, tasks, submit_g, job_submit_g, seeds, R)
    grid["p50"]   # float32[L, S] — one percentile per (load, seed) point

The reference runs the grid as ``jax.jit(vmap(vmap(point)))``.  PyTorch
has no ``vmap`` over a step with a host branch and a kernel launch, so the
batch is written out: the L x S points run as one batched state of B = L S
points (point ``b`` is load ``b // S``, seed ``b % S``), one round of
launches per round for all of them, and every match is one kernel launch
over the B points' rows.  Percentiles are reduced on the device
(``point_summary``), so a 50k-worker grid never builds per-task records on
the host.

``fig4_sweep`` is the fault-tolerance counterpart (paper §3.5, Fig. 4):
the grid axis is fault *severity* instead of load.  A batched
``FaultSchedule`` (leading axis = fraction of the DC crashed) gives each
point its schedule, the trace is shared, and the F x S points again run
as one batched state (point ``b`` is fraction ``b // S``, seed ``b % S``).

Sparrow and eagle grids are guarded by the reference's probe-memory
pre-flight (``check_probe_memory``).  ``sweep_grid(provenance=True)``
carries each point's per-task lifecycle arrays through the grid and adds
the delay-breakdown columns ``mean_<component>`` (``fault_sweep_grid``
has no such flag, as in the reference).  The sharded executors, which
split a grid's batch over a mesh of devices, are ``repro_torch.simx.shard``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.base import grid_workers
from repro_torch.device import resolve_device
from repro_torch.simx import engine, runtime, spans
from repro_torch.simx.faults import FaultSchedule, fault_grid_schedule
from repro_torch.simx.provenance import COMPONENTS, decompose_delays, init_provenance
from repro_torch.simx.runtime import MatchFn, default_match_fn
from repro_torch.simx.state import QueueState, SimxConfig, TaskArrays, export_workload
from repro_torch.workload.synth import synthetic_trace

log = logging.getLogger(__name__)


def point_summary(
    state,
    tasks: TaskArrays,
    has_queues: Optional[bool] = None,
    provenance=None,
    dt: Optional[float] = None,
) -> dict[str, torch.Tensor]:
    """Reduce a finished state to the Fig. 2 observables, on its device
    (the reference's ``point_summary``, same keys): p50/p95/mean job delay
    (Eq. 2, nan-excluding unfinished jobs, through the runtime's shared
    job-delay reduction), completion counts, the crash-loss counter, mean
    worker utilisation, control messages and probes, the inconsistency
    count and its per-task rate, and the reservation-queue counters
    ``res_overflow`` and ``probe_lag`` of a ``QueueState`` (a nonzero
    value flags a point distorted by a too-small ``reserve_cap`` /
    ``probe_window``; rules without queues report zeros).

    A batched state gives one value per point (``[B]``).  ``mean_util`` is
    exact in closed form: each launched task occupied its worker for
    ``clip(min(finish, t) - start, 0, duration)`` seconds.
    ``torch.nanquantile`` stands in for ``jnp.nanpercentile``; both
    interpolate linearly.

    ``has_queues`` gates the queue-counter reads (``Rule.has_queues``;
    default: the state's class).  ``provenance`` (a ``Provenance``, with
    ``dt``) adds the delay-breakdown columns ``mean_<component>``
    (``repro_torch.simx.provenance.COMPONENTS``): per-component nanmeans
    over completed jobs, summing to ``mean``."""
    with spans.span("sweep.point_summary"):
        t = runtime.lift(state.t, state.task_finish)
        done = state.task_finish <= t
        delays, job_finish = runtime.job_delays_from_state(state.task_finish, state.t, tasks)
        # min() before the subtraction: an unlaunched task has finish == inf,
        # and min(inf, t) - (inf - d) = -inf clips to 0 without an inf - inf nan
        busy = torch.minimum(
            torch.clamp(
                torch.minimum(state.task_finish, t) - (state.task_finish - tasks.duration),
                min=0.0,
            ),
            tasks.duration,
        )
        W = state.worker_finish.shape[-1]
        if has_queues is None:
            has_queues = isinstance(state, QueueState)
        zero = torch.zeros_like(state.lost)
        out = {
            "p50": torch.nanquantile(delays, 0.5, dim=-1),
            "p95": torch.nanquantile(delays, 0.95, dim=-1),
            "mean": torch.nanmean(delays, dim=-1),
            "jobs_done": torch.sum(torch.isfinite(job_finish), dim=-1, dtype=torch.int32),
            "tasks_done": torch.sum(done, dim=-1, dtype=torch.int32),
            "lost": state.lost,
            "mean_util": torch.sum(busy, dim=-1) / (W * torch.clamp(state.t, min=1e-9)),
            "messages": state.messages,
            "probes": state.probes,
            "inconsistencies": state.inconsistencies,
            "inconsistency_rate": state.inconsistencies.to(torch.float32)
            / torch.tensor(float(max(tasks.num_tasks, 1)), dtype=torch.float32,
                           device=state.lost.device),
            "res_overflow": state.res_overflow if has_queues else zero,
            "probe_lag": state.probe_lag if has_queues else zero,
        }
        if provenance is not None:
            if dt is None:
                raise ValueError("point_summary(provenance=...) needs dt")
            comp = decompose_delays(provenance, state.task_finish, state.t, tasks, dt)
            for key in COMPONENTS:
                out[f"mean_{key}"] = torch.nanmean(comp[key], dim=-1)
        return out


def probe_memory_bytes(
    scheduler: str,
    num_jobs: int,
    num_workers: int,
    n_points: int,
    tasks_per_job: int = 1000,
    probe_ratio: int = 2,
    reserve_cap: int = 0,
) -> int:
    """Estimated peak bytes of reservation-queue probe state a grid holds
    (the reference's estimate, unchanged); 0 for rules without queues.

    Per point: the carried ``int32[W, R]`` queue plus its per-round
    compaction/scatter intermediates (about 3 int32 copies), and the
    static probe-edge constants, O(d * T) int32."""
    rule = runtime.RULES.get(scheduler.lower())
    if rule is None or not rule.has_queues:
        return 0
    num_edges = num_jobs * min(probe_ratio * tasks_per_job, num_workers)
    cap = SimxConfig(
        num_workers=num_workers, probe_ratio=probe_ratio, reserve_cap=reserve_cap
    ).queue_cap(num_edges)
    per_point = 12 * num_workers * cap + 8 * num_edges
    return per_point * n_points


def check_probe_memory(
    scheduler: str,
    num_jobs: int,
    num_workers: int,
    n_points: int,
    limit_bytes: Optional[float],
    **kw,
) -> int:
    """Log the reservation-queue memory estimate and fail fast when it
    exceeds ``limit_bytes`` (None disables), before any state is built."""
    est = probe_memory_bytes(scheduler, num_jobs, num_workers, n_points, **kw)
    if not est:
        return est
    log.info(
        "%s grid: ~%.1f MiB reservation-queue state (J=%d, W=%d) across %d points",
        scheduler, est / 2**20, num_jobs, num_workers, n_points,
    )
    if limit_bytes is not None and est > limit_bytes:
        raise RuntimeError(
            f"{scheduler} sweep needs ~{est / 2**30:.2f} GiB of "
            f"reservation-queue state (J={num_jobs}, W={num_workers}) over "
            f"{n_points} grid points, above the {limit_bytes / 2**30:.2f} GiB "
            "limit. Shrink the grid (fewer loads/seeds per call), lower "
            "reserve_cap, or raise mem_limit_gb if the device really has the "
            "memory. megha/pigeon/oracle carry no probe state."
        )
    return est


def make_load_grid(
    loads: Sequence[float],
    *,
    num_jobs: int,
    tasks_per_job: int,
    num_workers: int,
    task_duration: float = 1.0,
    seed: int = 0,
    arrivals: str = "poisson",
    device=None,
) -> tuple[TaskArrays, torch.Tensor, torch.Tensor]:
    """One synthetic trace per load, stacked along a leading load axis.

    Returns ``(template, submit[L, T], job_submit[L, J])`` — the template
    carries the load-invariant structure (same trace seed => identical
    durations/shapes across loads; only arrival times move)."""
    dev = resolve_device(device)
    template = None
    submit, job_submit = [], []
    for load in loads:
        tasks = export_workload(
            synthetic_trace(
                num_jobs=num_jobs,
                tasks_per_job=tasks_per_job,
                task_duration=task_duration,
                load=load,
                num_workers=num_workers,
                seed=seed,
                arrivals=arrivals,
            ),
            dev,
        )
        if template is None:
            template = tasks
        submit.append(tasks.submit)
        job_submit.append(tasks.job_submit)
    return template, torch.stack(submit), torch.stack(job_submit)


def seed_draws(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    seeds: Sequence[int],
    draws: Optional[dict] = None,
) -> dict:
    """A grid's draws, one per seed (each ``[S, ...]``, on the CPU unless
    fed in): ``draws`` checked against the rule's, or each seed ``s`` drawn
    from ``torch.Generator().manual_seed(s)``, the draws
    ``simulate_workload(seed=s)`` makes."""
    rule = runtime.get_rule(scheduler)
    S = len(seeds)
    if draws is None:
        per_seed = [runtime.rule_draws(rule, cfg, tasks, s) for s in seeds]
        draws = {k: torch.stack([d[k] for d in per_seed]) for k in rule.draw_dims}
    elif set(draws) != set(rule.draw_dims):
        raise ValueError(f"{rule.name} draws {tuple(rule.draw_dims)}, got {tuple(draws)}")
    for k, dims in rule.draw_dims.items():
        if draws[k].dim() != dims + 1 or draws[k].shape[0] != S:
            raise ValueError(
                f"{rule.name}'s {k} must carry a leading axis of {S} seeds, "
                f"got {tuple(draws[k].shape)}")
    return draws


def build_grid(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    submit_grid: torch.Tensor,       # float32[L, T]
    job_submit_grid: torch.Tensor,   # float32[L, J]
    seeds: Sequence[int],
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    provenance: bool = False,
):
    """The grid as one batched run, not yet advanced: ``(step, state,
    tasks)`` with B = L x S points, point ``b`` = (load ``b // S``, seed
    ``b % S``), and ``tasks`` carrying each point's arrival times; with
    ``provenance`` the state is the ``(state, Provenance)`` carry.

    Seed ``s`` uses the rule's draws ``draws[k][s]`` (each ``[S, ...]``)
    when given, or megha's ``orders[s]`` (``int32[S, G, W]``), else the
    draws ``simulate_workload(seed=s)`` makes.  Pigeon and the oracle draw
    nothing; their seed copies of a load are identical, as in the
    reference."""
    with spans.span("sweep.build_grid"):
        name = scheduler.lower()
        rule = runtime.get_rule(name)
        seeds = [int(s) for s in seeds]
        L, S = submit_grid.shape[0], len(seeds)
        B = L * S
        point_tasks = tasks.replace(
            submit=submit_grid.repeat_interleave(S, dim=0),
            job_submit=job_submit_grid.repeat_interleave(S, dim=0),
        )
        draws = seed_draws(name, cfg, tasks, seeds, runtime.orders_as_draws(orders, draws))
        # seeds repeat over loads: point b takes seed b % S
        draws = {k: v.to(tasks.device).repeat((L,) + (1,) * (v.dim() - 1))
                 for k, v in draws.items()}
        step = rule.build_step(cfg, point_tasks, draws, match_fn=match_fn, provenance=provenance)
        state = rule.init(cfg, point_tasks, B)
        if provenance:
            state = (state, init_provenance(tasks.num_tasks, tasks.device, B))
        return step, state, point_tasks


def grid_state(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    submit_grid: torch.Tensor,
    job_submit_grid: torch.Tensor,
    seeds: Sequence[int],
    num_rounds: int,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    provenance: bool = False,
):
    """Run the grid exactly ``num_rounds`` rounds from a fresh DC (each
    point is ``runtime.simulate_fixed`` of that point); returns ``(final
    batched state, point tasks, step)``, the state a ``(state,
    Provenance)`` carry with ``provenance``."""
    step, state, point_tasks = build_grid(
        scheduler, cfg, tasks, submit_grid, job_submit_grid, seeds, match_fn, orders, draws,
        provenance)
    return runtime.scan_rounds(step, state, num_rounds), point_tasks, step


def sweep_grid(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    submit_grid: torch.Tensor,       # float32[L, T]
    job_submit_grid: torch.Tensor,   # float32[L, J]
    seeds: Sequence[int],
    num_rounds: int,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    provenance: bool = False,
) -> dict[str, torch.Tensor]:
    """Run the whole (load x seed) grid as one batched program; returns the
    ``point_summary`` fields as ``[L, S]`` tensors on the grid's device.
    ``provenance=True`` carries the per-task lifecycle arrays through every
    point and adds the ``mean_<component>`` delay-breakdown columns."""
    state, point_tasks, _ = grid_state(
        scheduler, cfg, tasks, submit_grid, job_submit_grid, seeds, num_rounds,
        match_fn, orders, draws, provenance)
    prov = None
    if provenance:
        state, prov = state
    L, S = submit_grid.shape[0], len(seeds)
    summary = point_summary(state, point_tasks, provenance=prov, dt=cfg.dt)
    return {k: v.reshape(L, S) for k, v in summary.items()}


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Everything a Fig. 2 grid run needs, built once (the reference's
    ``SweepPlan``, with fed-in draws beside its seeds)."""

    name: str
    cfg: SimxConfig
    tasks: TaskArrays
    submit_grid: torch.Tensor        # float32[L, T]
    job_submit_grid: torch.Tensor    # float32[L, J]
    seeds: tuple[int, ...]           # [S]
    num_rounds: int
    match_fn: MatchFn
    draws: Optional[dict]            # the rule's draws, each [S, ...], or None
    provenance: bool                 # carry the lifecycle arrays, add mean_<component>
    annotate: dict                   # numpy extras merged into the result


def fig2_plan(
    scheduler: str,
    *,
    loads: Sequence[float] = (0.2, 0.5, 0.8),
    num_seeds: int = 3,
    num_workers: int = 10_000,
    num_jobs: int = 200,
    tasks_per_job: int = 1000,
    dt: float = 0.05,
    slack: float = 4.0,
    trace_seed: int = 0,
    use_kernel: bool = True,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    mem_limit_gb: Optional[float] = 16.0,
    device=None,
    provenance: bool = False,
    **cfg_kwargs,
) -> SweepPlan:
    """Build the Fig. 2 grid inputs without running them: the load grid,
    the shared config, and the round budget sized off the slowest point.
    Megha's worker count is shaved to its GM x LM grid first
    (``grid_workers``) and the trace is built at that count, as the
    reference does.  ``mem_limit_gb`` bounds the reservation-queue state
    of a sparrow/eagle grid (``check_probe_memory``; None disables)."""
    name = scheduler.lower()
    if runtime.get_rule(name).needs_grid:
        num_workers = grid_workers(
            num_workers, cfg_kwargs.get("num_gms", 8), cfg_kwargs.get("num_lms", 8)
        )
    check_probe_memory(
        name, num_jobs, num_workers, len(loads) * num_seeds,
        None if mem_limit_gb is None else mem_limit_gb * 2**30,
        tasks_per_job=tasks_per_job,
        probe_ratio=cfg_kwargs.get("probe_ratio", 2),
        reserve_cap=cfg_kwargs.get("reserve_cap", 0),
    )
    cfg = SimxConfig(num_workers=num_workers, dt=dt, **cfg_kwargs)
    tasks, submit_g, job_submit_g = make_load_grid(
        loads,
        num_jobs=num_jobs,
        tasks_per_job=tasks_per_job,
        num_workers=num_workers,
        seed=trace_seed,
        device=device,
    )
    num_rounds = max(
        engine.estimate_rounds(
            cfg, tasks.replace(submit=submit_g[i], job_submit=job_submit_g[i]), slack=slack,
        )
        for i in range(len(loads))
    )
    return SweepPlan(
        name=name,
        cfg=cfg,
        tasks=tasks,
        submit_grid=submit_g,
        job_submit_grid=job_submit_g,
        seeds=tuple(range(num_seeds)),
        num_rounds=num_rounds,
        match_fn=default_match_fn(use_kernel),
        draws=runtime.orders_as_draws(orders, draws),
        provenance=provenance,
        annotate={
            "loads": np.asarray(loads),
            "num_rounds": np.asarray(num_rounds),
            "num_tasks": np.asarray(tasks.num_tasks),
        },
    )


def fig2_sweep(
    scheduler: str,
    *,
    loads: Sequence[float] = (0.2, 0.5, 0.8),
    num_seeds: int = 3,
    num_workers: int = 10_000,
    num_jobs: int = 200,
    tasks_per_job: int = 1000,
    dt: float = 0.05,
    slack: float = 4.0,
    trace_seed: int = 0,
    use_kernel: bool = True,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    mem_limit_gb: Optional[float] = 16.0,
    device=None,
    provenance: bool = False,
    **cfg_kwargs,
) -> dict[str, np.ndarray]:
    """Build the load grid, size the round budget off the slowest point,
    run the grid as one batched program on ``device`` (``None`` = the CUDA
    card), return numpy arrays.

    The defaults mirror the paper's synthetic trace (jobs of 1000
    one-second tasks).  ``use_kernel`` selects the rank-and-select kernel
    (the default) or its plain version; ``draws`` (the rule's draws, each
    ``[S, ...]``) or, for megha, ``orders`` (``int32[S, G, W]``) feed in
    the seeds' random draws, e.g. the reference's.  ``provenance=True``
    adds the ``mean_<component>`` delay-breakdown columns."""
    plan = fig2_plan(
        scheduler,
        loads=loads, num_seeds=num_seeds, num_workers=num_workers,
        num_jobs=num_jobs, tasks_per_job=tasks_per_job, dt=dt, slack=slack,
        trace_seed=trace_seed, use_kernel=use_kernel, orders=orders, draws=draws,
        mem_limit_gb=mem_limit_gb, device=device, provenance=provenance, **cfg_kwargs,
    )
    out = sweep_grid(
        plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
        plan.seeds, plan.num_rounds, match_fn=plan.match_fn, draws=plan.draws,
        provenance=plan.provenance,
    )
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res.update(plan.annotate)
    return res


def build_fault_grid(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    schedules: FaultSchedule,        # leaves carry a leading severity axis [F]
    seeds: Sequence[int],
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
):
    """The Fig. 4 grid as one batched run, not yet advanced: ``(step,
    state)`` with B = F x S points, point ``b`` = (severity ``b // S``,
    seed ``b % S``), on ``tasks``' device.  Each severity's schedule row
    repeats over the seeds and the seeds' draws repeat over the
    severities, as ``build_grid`` does for loads."""
    name = scheduler.lower()
    rule = runtime.get_rule(name)
    if schedules.batch is None:
        raise ValueError("a fault grid needs schedules with a leading severity axis")
    seeds = [int(s) for s in seeds]
    F, S = schedules.batch, len(seeds)
    point_faults = FaultSchedule(**{
        f.name: getattr(schedules, f.name).repeat_interleave(S, dim=0)
        for f in dataclasses.fields(FaultSchedule)
    }).to(tasks.device)
    draws = seed_draws(name, cfg, tasks, seeds, runtime.orders_as_draws(orders, draws))
    # seeds repeat over severities: point b takes seed b % S
    draws = {k: v.to(tasks.device).repeat((F,) + (1,) * (v.dim() - 1))
             for k, v in draws.items()}
    step = rule.build_step(cfg, tasks, draws, match_fn=match_fn, faults=point_faults)
    return step, rule.init(cfg, tasks, F * S)


def fault_grid_state(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    schedules: FaultSchedule,
    seeds: Sequence[int],
    num_rounds: int,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
):
    """Run the Fig. 4 grid exactly ``num_rounds`` rounds from a fresh DC
    (each point is ``runtime.simulate_fixed`` of that point under its
    schedule); returns ``(final batched state, step)``."""
    step, state = build_fault_grid(
        scheduler, cfg, tasks, schedules, seeds, match_fn, orders, draws)
    return runtime.scan_rounds(step, state, num_rounds), step


def fault_sweep_grid(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    schedules: FaultSchedule,        # leaves carry a leading severity axis [F]
    seeds: Sequence[int],
    num_rounds: int,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
) -> dict[str, torch.Tensor]:
    """Run a (fault severity x seed) grid as one batched program, the
    Fig. 4 counterpart of ``sweep_grid``.  Returns the ``point_summary``
    fields as ``[F, S]`` tensors (``lost`` counts the in-flight tasks
    crashes destroyed per point)."""
    state, _ = fault_grid_state(
        scheduler, cfg, tasks, schedules, seeds, num_rounds, match_fn, orders, draws)
    F, S = schedules.batch, len(seeds)
    return {k: v.reshape(F, S) for k, v in point_summary(state, tasks).items()}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The Fig. 4 counterpart of ``SweepPlan``: one batched
    ``FaultSchedule`` (leading severity axis) instead of submit grids (the
    reference's ``sweep.FaultPlan``; ``repro_torch.simx.FaultPlan`` is the
    backend-neutral plan of ``faults``, as in the reference)."""

    name: str
    cfg: SimxConfig
    tasks: TaskArrays
    schedules: FaultSchedule         # leaves carry a leading severity axis [F]
    seeds: tuple[int, ...]           # [S]
    num_rounds: int
    match_fn: MatchFn
    draws: Optional[dict]            # the rule's draws, each [S, ...], or None
    annotate: dict


def fig4_plan(
    scheduler: str,
    *,
    fractions: Sequence[float] = (0.0, 0.02, 0.05, 0.1),
    fail_time: Optional[float] = None,
    outage: float = 2.0,
    gm_outages: int = 0,
    heartbeat_delay: float = 0.0,
    num_seeds: int = 2,
    load: float = 0.8,
    num_workers: int = 1024,
    num_jobs: int = 32,
    tasks_per_job: int = 128,
    dt: float = 0.05,
    slack: float = 6.0,
    trace_seed: int = 0,
    fault_seed: int = 0,
    use_kernel: bool = True,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    mem_limit_gb: Optional[float] = 16.0,
    device=None,
    **cfg_kwargs,
) -> FaultPlan:
    """Build the Fig. 4 grid inputs without running them: the batched
    severity schedule, the trace, and the outage-extended round budget,
    on ``device`` (``None`` = the CUDA card).  Megha's worker count is
    shaved to its GM x LM grid first, and only megha takes GM outages."""
    name = scheduler.lower()
    if runtime.get_rule(name).needs_grid:
        num_workers = grid_workers(
            num_workers, cfg_kwargs.get("num_gms", 8), cfg_kwargs.get("num_lms", 8)
        )
    check_probe_memory(
        name, num_jobs, num_workers, len(fractions) * num_seeds,
        None if mem_limit_gb is None else mem_limit_gb * 2**30,
        tasks_per_job=tasks_per_job,
        probe_ratio=cfg_kwargs.get("probe_ratio", 2),
        reserve_cap=cfg_kwargs.get("reserve_cap", 0),
    )
    dev = resolve_device(device)
    cfg = SimxConfig(num_workers=num_workers, dt=dt, **cfg_kwargs)
    tasks = export_workload(
        synthetic_trace(
            num_jobs=num_jobs,
            tasks_per_job=tasks_per_job,
            load=load,
            num_workers=num_workers,
            seed=trace_seed,
        ),
        dev,
    )
    if fail_time is None:
        fail_time = 0.5 * float(torch.max(tasks.submit))
    schedules = fault_grid_schedule(
        num_workers,
        cfg.num_gms,
        fractions,
        fail_time=fail_time,
        outage=outage,
        gm_outages=gm_outages if name == "megha" else 0,
        dt=dt,
        heartbeat_delay=heartbeat_delay,
        seed=fault_seed,
        device=dev,
    )
    num_rounds = engine.estimate_rounds(cfg, tasks, slack=slack) + int(
        math.ceil((fail_time + outage) / dt)
    )
    return FaultPlan(
        name=name,
        cfg=cfg,
        tasks=tasks,
        schedules=schedules,
        seeds=tuple(range(num_seeds)),
        num_rounds=num_rounds,
        match_fn=default_match_fn(use_kernel),
        draws=runtime.orders_as_draws(orders, draws),
        annotate={
            "fractions": np.asarray(fractions),
            "fail_time": np.asarray(fail_time),
            "outage": np.asarray(outage),
            "num_rounds": np.asarray(num_rounds),
            "num_tasks": np.asarray(tasks.num_tasks),
        },
    )


def fig4_sweep(
    scheduler: str,
    *,
    fractions: Sequence[float] = (0.0, 0.02, 0.05, 0.1),
    fail_time: Optional[float] = None,
    outage: float = 2.0,
    gm_outages: int = 0,
    heartbeat_delay: float = 0.0,
    num_seeds: int = 2,
    load: float = 0.8,
    num_workers: int = 1024,
    num_jobs: int = 32,
    tasks_per_job: int = 128,
    dt: float = 0.05,
    slack: float = 6.0,
    trace_seed: int = 0,
    fault_seed: int = 0,
    use_kernel: bool = True,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    mem_limit_gb: Optional[float] = 16.0,
    device=None,
    **cfg_kwargs,
) -> dict[str, np.ndarray]:
    """The Fig. 4 availability study: one batched (severity x seed) grid on
    ``device`` (``None`` = the CUDA card), returned as numpy arrays.

    Each severity point crashes ``fraction * num_workers`` random workers
    at ``fail_time`` (default: mid-arrival-span) for ``outage`` seconds,
    plus, for megha, ``gm_outages`` GMs over the same window and an
    optional heartbeat-delay perturbation.  ``use_kernel``, ``orders`` and
    ``draws`` are ``fig2_sweep``'s."""
    plan = fig4_plan(
        scheduler,
        fractions=fractions, fail_time=fail_time, outage=outage,
        gm_outages=gm_outages, heartbeat_delay=heartbeat_delay,
        num_seeds=num_seeds, load=load, num_workers=num_workers,
        num_jobs=num_jobs, tasks_per_job=tasks_per_job, dt=dt, slack=slack,
        trace_seed=trace_seed, fault_seed=fault_seed, use_kernel=use_kernel,
        orders=orders, draws=draws, mem_limit_gb=mem_limit_gb, device=device,
        **cfg_kwargs,
    )
    out = fault_sweep_grid(
        plan.name, plan.cfg, plan.tasks, plan.schedules, plan.seeds,
        plan.num_rounds, match_fn=plan.match_fn, draws=plan.draws,
    )
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res.update(plan.annotate)
    return res
