"""Sharded sweep executors: the grids' batch axis laid across a mesh of
devices (port of ``repro/simx/shard.py``).

The Fig. 2 / Fig. 4 grids and the steady-state load sweep are pure data
parallelism: the same round-stage program over different arrival times,
draws, fault schedules or arrival streams, with no exchange between points
until each point reduces to its own ``point_summary`` scalars.
``repro_torch.simx.sweep`` runs a grid as one batched state on one device;
this module splits that batch over a 1-D mesh of devices:

  * ``sweep_mesh(n_devices, device)`` builds the mesh (a function, never a
    module constant: importing this module touches no device).  In the
    port a ``Mesh`` is a frozen tuple of ``torch.device``s.
  * ``sharded_sweep_grid`` / ``sharded_fig2_sweep`` flatten the (load x
    seed) axes to one batch axis (``GridShard``), pad it to a multiple of
    the mesh size, and give each mesh entry its contiguous slice, which
    runs on that entry's device as the batched program the serial grid
    runs (``runtime.simulate_fixed`` of that many points, then
    ``sweep.point_summary``).  The summaries are gathered to the first
    entry and sliced back to ``[rows, cols]``.  ``sharded_fig4_sweep``
    does the same for the (severity x seed) fault grids over the
    ``FaultSchedule`` leaves.
  * ``sharded_steady_state`` batches ``stream.run_steady_state``'s load
    axis: one ring-buffer window per arrival process over one shared
    ``stream_config``, the segment run lane-batched (``stream
    ._segment_core`` on every window field and layout field stacked to
    ``[L, ...]``, the P² sketch absorbed for every lane in one launch),
    then each live lane refilled on the host, by the host loop the serial
    ``run_steady_state`` runs (``stream._SteadyLoop``): a whole
    tail-latency-vs-load curve as one program.

**Executors.**  The reference runs each slice under ``jax.pmap``; here an
entry's slice is a batched state on its device, and one host thread runs
the entries one after another: ``_batched_runner`` runs an entry's whole
program (every round, with its host reads, such as megha's borrow check)
before the next entry's, so on several cards nothing overlaps.
A mesh may name one device several times (``Mesh(("cpu",) * 8)``): the
pad / split / gather path then runs on one CPU or one card, as the
reference's tests force several CPU devices with
``--xla_force_host_platform_device_count``.  ``sweep_mesh`` never builds
such a mesh.  More than one card cannot be tested on a one-card machine:
that path is written, not measured.

**Pad semantics** follow the reference exactly.  A batch of B real
points is padded to the next mesh multiple by repeating the last real
point (``pad_batch``); a lane count is padded by repeating lane 0.  Pad
points run like any other, but every observable is reduced within its own
point, so the pads cannot touch real outputs and are sliced off after the
gather: uneven grids return the serial entry points' numbers bitwise.

**Randomness.**  The reference carries a per-point PRNG key; the port's
rules take their draws as an argument, so a ``GridShard`` carries each
point's draws (megha's GM orders, the probe targets and eagle's rotations,
from ``sweep.seed_draws``: fed in with ``draws=`` / ``orders=``, or drawn
per seed) and every point is bitwise the serial grid's.  Every lane of the
steady state uses the one shared GM order drawn from ``seed`` (or
``orders=``), and every window draws its per-job quantities from ``seed``,
as the reference's lanes share ``cfg.seed``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.simx import runtime
from repro_torch.simx import stream as _stream
from repro_torch.simx import sweep as _sweep
from repro_torch.simx.faults import FaultSchedule
from repro_torch.simx.runtime import MatchFn
from repro_torch.simx.state import SimxConfig, TaskArrays, spec
from repro_torch.workload.synth import ArrivalProcess


class Mesh(tuple):
    """A 1-D device mesh: a frozen tuple of ``torch.device``s, the entries
    of the batch axis in order.  An entry may repeat a device."""

    def __new__(cls, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devs)


def sweep_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (default: all), or
    over the one CPU with ``device="cpu"``: the batch axis of every
    sharded executor.  ``device=None`` means the cards, and raises without
    one.  A function, not a module constant: importing this module touches
    no device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(
            f"sweep_mesh(n_devices={n_devices}): {dev.type} offers {len(devs)} "
            "device(s); need 1 <= n_devices <= that (a Mesh may name one device "
            "several times, Mesh((device,) * k), to split a batch k ways on it)"
        )
    return Mesh(devs[:n])


def pad_batch(tree, n_real: int, multiple: int):
    """Pad every tensor's leading batch axis from ``n_real`` up to the next
    multiple of ``multiple`` by repeating the last real entry.  Returns
    ``(padded_tree, n_padded)`` (the tree itself when no pad is needed).
    Pad entries are real computations whose outputs the caller slices off
    (``[:n_real]``) after the gather; per-point reductions mean they
    cannot affect the real points."""
    if multiple < 1 or n_real < 1:
        raise ValueError("pad_batch needs n_real >= 1 and multiple >= 1")
    n_pad = -(-n_real // multiple) * multiple
    if n_pad == n_real:
        return tree, n_real

    def pad(x):
        reps = x[n_real - 1 : n_real].expand((n_pad - n_real,) + x.shape[1:])
        return torch.cat([x, reps], dim=0)

    return runtime.tree_map(pad, tree), n_pad


# ---------------------------------------------------------------------------
# the sharded grids
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GridShard:
    """The flattened (row x col) batch of Fig. 2 grid points, the one
    batched argument of a sharded grid program.  B is the batch size;
    entry ``b = i * cols + j`` carries row (load) i and column (seed) j.
    ``draws`` holds each point's draws (the rule's, ``[B, ...]`` each; the
    reference's per-point PRNG key ``seed``)."""

    submit: torch.Tensor = spec("float32[B, T]")
    job_submit: torch.Tensor = spec("float32[B, J]")
    draws: dict = dataclasses.field(default_factory=dict)


def make_grid_shard(
    submit_grid: torch.Tensor,
    job_submit_grid: torch.Tensor,
    draws: dict,
    cols: int,
) -> tuple[GridShard, int, int]:
    """Flatten (load x seed) inputs to one batch axis: returns
    ``(GridShard with B = rows * cols, rows, cols)``, row-major, so the
    reshape ``[:B].reshape(rows, cols)`` restores the grid.  ``draws``
    holds the seeds' draws (each ``[cols, ...]``), tiled over the rows."""
    rows = int(submit_grid.shape[0])
    return (
        GridShard(
            submit=submit_grid.repeat_interleave(cols, dim=0),
            job_submit=job_submit_grid.repeat_interleave(cols, dim=0),
            draws={k: v.repeat((rows,) + (1,) * (v.dim() - 1)) for k, v in draws.items()},
        ),
        rows,
        cols,
    )


def _batched_runner(point: Callable, batch, n_real: int, rows: int, cols: int,
                    mesh: Mesh) -> Callable[[], dict]:
    """Wrap a batched point function into a zero-argument runner: pad the
    batch to a mesh multiple, give each entry its contiguous slice on its
    device, run ``point`` on each slice (one batched program per entry),
    gather the summaries to the first entry and slice / reshape them back
    to ``[rows, cols]``.  The runner can be called again without
    rebuilding its inputs."""
    batch, n_padded = pad_batch(batch, n_real, len(mesh))
    slices = runtime.split_batch(batch, mesh, n_padded // len(mesh))

    def run() -> dict[str, torch.Tensor]:
        out = runtime.gather_batch([point(part) for part in slices], mesh[0])
        return {k: v[:n_real].reshape((rows, cols) + v.shape[1:]) for k, v in out.items()}

    return run


def _on(tasks: TaskArrays, device: torch.device) -> TaskArrays:
    return runtime.tree_map(lambda x: x.to(device), tasks)


def sharded_grid_program(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    submit_grid: torch.Tensor,       # float32[L, T]
    job_submit_grid: torch.Tensor,   # float32[L, J]
    seeds: Sequence[int],
    num_rounds: int,
    *,
    mesh: Optional[Mesh] = None,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    provenance: bool = False,
) -> Callable[[], dict]:
    """Build (without running) the sharded (load x seed) grid program:
    ``sweep_grid``'s batched program on each mesh entry's slice.  Returns
    a zero-argument runner producing the same ``[L, S]`` summary dict as
    ``sweep_grid``, on the first entry's device.  ``mesh`` defaults to
    every card (or the CPU, for tasks there); ``draws`` / ``orders`` are
    ``sweep_grid``'s."""
    name = scheduler.lower()
    rule = runtime.get_rule(name)  # fail fast on unknown schedulers
    mesh = sweep_mesh(device=tasks.device) if mesh is None else mesh
    seeds = [int(s) for s in seeds]
    draws = _sweep.seed_draws(name, cfg, tasks, seeds, runtime.orders_as_draws(orders, draws))
    flat, rows, cols = make_grid_shard(submit_grid, job_submit_grid, draws, len(seeds))

    def point(g: GridShard):
        tk = _on(tasks, g.submit.device).replace(submit=g.submit, job_submit=g.job_submit)
        state = runtime.simulate_fixed(name, cfg, tk, g.draws, num_rounds, match_fn=match_fn,
                                       provenance=provenance)
        prov = None
        if provenance:
            state, prov = state
        return _sweep.point_summary(state, tk, has_queues=rule.has_queues, provenance=prov,
                                    dt=cfg.dt)

    return _batched_runner(point, flat, rows * cols, rows, cols, mesh)


def sharded_sweep_grid(
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
    mesh: Optional[Mesh] = None,
) -> dict[str, torch.Tensor]:
    """Drop-in sharded ``sweep.sweep_grid``: its signature plus ``mesh``,
    its ``[L, S]`` outputs bitwise; the batch is padded to a mesh multiple
    and the pad points sliced off, so uneven grids return the same
    numbers."""
    return sharded_grid_program(
        scheduler, cfg, tasks, submit_grid, job_submit_grid, seeds, num_rounds,
        mesh=mesh, match_fn=match_fn, orders=orders, draws=draws, provenance=provenance,
    )()


def sharded_fault_program(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    schedules: FaultSchedule,        # leaves carry a leading severity axis [F]
    seeds: Sequence[int],
    num_rounds: int,
    *,
    mesh: Optional[Mesh] = None,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
) -> Callable[[], dict]:
    """The Fig. 4 counterpart of ``sharded_grid_program``: the flattened
    (severity x seed) axis across the mesh, each severity's
    ``FaultSchedule`` row repeated per seed and the seeds' draws tiled over
    the severities (``sweep.build_fault_grid``'s points)."""
    name = scheduler.lower()
    rule = runtime.get_rule(name)  # fail fast on unknown schedulers
    if schedules.batch is None:
        raise ValueError("a fault grid needs schedules with a leading severity axis")
    mesh = sweep_mesh(device=tasks.device) if mesh is None else mesh
    seeds = [int(s) for s in seeds]
    rows, cols = schedules.batch, len(seeds)
    draws = _sweep.seed_draws(name, cfg, tasks, seeds, runtime.orders_as_draws(orders, draws))
    batch = (
        runtime.tree_map(lambda x: x.repeat_interleave(cols, dim=0), schedules),
        {k: v.repeat((rows,) + (1,) * (v.dim() - 1)) for k, v in draws.items()},
    )

    def point(p):
        fs, dr = p
        tk = _on(tasks, fs.worker_down.device)
        state = runtime.simulate_fixed(name, cfg, tk, dr, num_rounds, match_fn=match_fn,
                                       faults=fs)
        return _sweep.point_summary(state, tk, has_queues=rule.has_queues)

    return _batched_runner(point, batch, rows * cols, rows, cols, mesh)


def sharded_fault_sweep_grid(
    scheduler: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    schedules: FaultSchedule,
    seeds: Sequence[int],
    num_rounds: int,
    match_fn: MatchFn | None = None,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    mesh: Optional[Mesh] = None,
) -> dict[str, torch.Tensor]:
    """Drop-in sharded ``sweep.fault_sweep_grid`` (the same ``[F, S]``
    outputs; see ``sharded_sweep_grid`` for the pad contract)."""
    return sharded_fault_program(
        scheduler, cfg, tasks, schedules, seeds, num_rounds,
        mesh=mesh, match_fn=match_fn, orders=orders, draws=draws,
    )()


def _plan_kw(mesh: Optional[Mesh], kw: dict) -> dict:
    """A plan's keywords: built on the mesh's first device unless the
    caller names one."""
    if mesh is not None:
        kw = dict(kw)
        kw.setdefault("device", mesh[0])
    return kw


def _numpy(out: dict, plan, mesh: Mesh) -> dict[str, np.ndarray]:
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res.update(plan.annotate)
    res["n_devices"] = np.asarray(len(mesh))
    return res


def sharded_fig2_sweep(
    scheduler: str, *, mesh: Optional[Mesh] = None, **kw
) -> dict[str, np.ndarray]:
    """Sharded ``sweep.fig2_sweep``: its keywords (``device`` among them:
    None is the cards, and raises without one), its grid (one shared
    ``fig2_plan``), the (load x seed) batch split over ``mesh`` (default:
    every device of the plan's kind).  Adds ``n_devices`` to the result."""
    plan = _sweep.fig2_plan(scheduler, **_plan_kw(mesh, kw))
    mesh = sweep_mesh(device=plan.tasks.device) if mesh is None else mesh
    out = sharded_grid_program(
        plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
        plan.seeds, plan.num_rounds, mesh=mesh, match_fn=plan.match_fn, draws=plan.draws,
        provenance=plan.provenance,
    )()
    return _numpy(out, plan, mesh)


def sharded_fig4_sweep(
    scheduler: str, *, mesh: Optional[Mesh] = None, **kw
) -> dict[str, np.ndarray]:
    """Sharded ``sweep.fig4_sweep``: its keywords, its schedules (one
    shared ``fig4_plan``), the (severity x seed) batch split over
    ``mesh``.  Adds ``n_devices`` to the result."""
    plan = _sweep.fig4_plan(scheduler, **_plan_kw(mesh, kw))
    mesh = sweep_mesh(device=plan.tasks.device) if mesh is None else mesh
    out = sharded_fault_program(
        plan.name, plan.cfg, plan.tasks, plan.schedules, plan.seeds, plan.num_rounds,
        mesh=mesh, match_fn=plan.match_fn, draws=plan.draws,
    )()
    return _numpy(out, plan, mesh)


# ---------------------------------------------------------------------------
# the sharded steady state
# ---------------------------------------------------------------------------


def sharded_steady_state(rule: str, arrivals: Sequence[ArrivalProcess], num_workers: int, *,
                         mesh: Optional[Mesh] = None, device=None,
                         **kw) -> list[_stream.SteadyRun]:
    """Run one streaming steady-state lane per arrival process, a whole
    tail-latency-vs-offered-load curve, as one lane-batched program.

    Takes ``run_steady_state``'s keywords (``window_jobs``,
    ``window_tasks``, ``rounds_per_refill``, ``horizon``, ``max_rounds``,
    ``quantiles``, ``collect_delays``, ``match_fn``, ``use_kernel``,
    ``num_gms``, ``num_lms``, ``dt``, ``seed``, megha's ``orders``,
    ``device`` and ``SimxConfig`` fields) but telemetry and provenance,
    which stay on the serial path as in the reference, plus ``mesh``
    (default: ``sweep_mesh(device=device)``; ``device`` None is the cards,
    and raises without one).

    Each lane gets its own ring-buffer window over one shared
    ``stream_config`` (same capacities, so the layouts stack); every
    segment advances all lanes at once through the lane-batched segment,
    split over the mesh, then each live lane refills on the host, through
    the host loop ``run_steady_state`` runs (``stream._SteadyLoop``).  The
    lanes' clocks, losses, gauges, borrow counts and sketch quantiles
    after a segment come to the host in one read.  A lane that drains (or
    trips ``horizon`` / ``max_rounds``) is frozen: its state and sketch
    stop updating while the other lanes run on (it still fills its place
    in the batch, like a pad).  The lane count is padded to a mesh
    multiple by repeating lane 0; pad lanes are dropped before returning.
    The P² absorb is the kernel for every lane in one launch (or its plain
    version with ``use_kernel=False``); megha's lanes all use one GM
    order, ``orders=`` or drawn from ``seed``.

    Returns one ``SteadyRun`` per lane, in ``arrivals`` order, each
    bitwise ``run_steady_state``'s run of that lane (its ``segment_seconds``
    is the shared wall of the segments it took part in)."""
    mesh = sweep_mesh(device=device) if mesh is None else mesh
    return _stream._SteadyLoop(rule, list(arrivals), num_workers, devices=mesh,
                               entry="sharded_steady_state", **kw).run()
