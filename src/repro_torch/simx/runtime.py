"""Shared round-stage runtime (port of ``repro/simx/runtime.py``).

Every rule advances the datacenter through the same round pipeline;
only the dispatch in the middle differs.  ``compose_step`` assembles it:

  1. **faults** — ``fault_stage``: the crash transition of a fault
     schedule (``repro_torch.simx.faults``), shared by every rule; it is
     left out of the step when there is no schedule.
  2. **complete** — ``completion_masks``: ground-truth free/completed-now
     masks from ``worker_finish`` crossing the round time.
  3. **rule.dispatch** — the scheduler-specific stage, built from the
     windowed-FIFO helpers (``slice_rows``, ``sorted_fifo``,
     ``window_launched``, ``launched_lead``) and the launch bookkeeping
     (``apply_launch``); returns the state-field updates as a dict.
  4. **telemetry** (``compose_step(..., telemetry=True)``) — the runtime
     pops the rule's per-round counters (``launches`` and rule extras) and
     adds the new - old deltas of the shared state counters; the step
     returns ``(state, counters)`` for the decimated collection loop
     (``repro_torch.simx.telemetry``).
  5. **provenance** (``compose_step(..., provenance=True)``) — the carry
     becomes ``(state, Provenance)`` and the runtime derives each round's
     per-task lifecycle transitions (``repro_torch.simx.provenance``),
     folding in the rule's ``"provenance"`` extras.
  6. **advance** — the runtime folds the updates into a new state and
     advances ``t``/``rnd`` and the crash-loss counter ``lost``.

Stages 4 and 5 are decided in Python when the step is built: without the
flags nothing of them is built, and the step issues the same operations
as before them.  Callers read the state of a possibly-tuple carry with
``carry_state``.

Each stage opens a span of ``repro_torch.simx.spans`` (``simx.faults``,
``simx.complete``, ``simx.dispatch``, ``simx.advance``, and
``simx.provenance`` / ``simx.telemetry`` where built), and each pass of
``scan_rounds``' loop a ``simx.round`` span with the loop counter as its
round index: recorded under the profiler or in a session, no-ops else.

``jax.lax.scan`` becomes a Python loop (``scan_rounds``), and the
reference's ``mode="drop"`` scatters become scatters into a padded slot
that is sliced off again: torch has no drop mode, and clamping the index
would overwrite a real slot.

**The point axis.**  The reference runs a sweep grid as ``vmap`` over
``simulate_fixed``; PyTorch has no ``vmap`` over a step with a host
branch and a kernel launch, so the batch is written out: every state
field of a *batched* state carries a leading axis of B grid points, and
the helpers and steps work on it.  A single run is B = 1:
``scan_rounds`` (and a step called directly) lifts an unbatched state to
B = 1 and drops the axis again, so single runs keep their shapes.  The
helpers work on any leading axes, unbatched inputs included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable

import torch

from repro_torch.kernels import match, ref
from repro_torch.simx import spans
from repro_torch.simx.faults import FaultSchedule, apply_worker_faults
from repro_torch.simx.state import QueueState, SimxConfig, TaskArrays

#: rank-and-select primitive: (avail bool[B, N], n int32[B]) -> ranks
#: int32[B, N] (rank of each selected column, -1 where unselected).
MatchFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def default_match_fn(use_kernel: bool = True) -> MatchFn:
    """The match primitive every rule ranks-and-selects with.

    ``use_kernel=True`` (the main path) is the kernel wrapper: the CUDA
    kernel for a tensor on the card, the plain version for one on the CPU.
    ``use_kernel=False`` is the plain version on any device, so that a run
    on the card can be held against the same run without the kernel."""
    return match.match_ranks_batched if use_kernel else ref.match_ranks_batched_ref


# ---------------------------------------------------------------------------
# the point axis
# ---------------------------------------------------------------------------


def lift(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (one value per point, ``[B]`` or ``[]``) with trailing unit
    axes, so it broadcasts against ``like`` (``[B, ...]`` or unbatched)."""
    if x.dim() == like.dim():
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _broadcast(a: tuple, b: tuple) -> tuple:
    """Two leading shapes broadcast together, in plain Python: this runs
    several times a round, where ``torch.broadcast_shapes``' host cost
    shows in the host-bound round."""
    n = max(len(a), len(b))
    a = (1,) * (n - len(a)) + tuple(a)
    b = (1,) * (n - len(b)) + tuple(b)
    return tuple(y if x == 1 else x for x, y in zip(a, b))


@lru_cache(maxsize=None)
def point_rows(n: int, ndim: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` shaped ``[n, 1, ...]`` (``ndim`` axes): the point index
    of an advanced-indexing gather, made once per shape and device (every
    op of a round costs host time, and the round is host-bound)."""
    return torch.arange(n, device=device).reshape((n,) + (1,) * (ndim - 1))


def take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[..., idx]`` along the last axis, per point: ``src [*P, N]``
    and ``idx [*P, *K]`` (``P`` the point axes, each of size 1 or B on
    either side) give ``[*P, *K]``.  A 1-D ``src`` is plain indexing, a
    2-D one one advanced index; wider ``src`` need ``idx`` of its rank."""
    if idx.dtype != torch.int64:
        idx = idx.to(torch.int64)
    if src.dim() == 1:
        return src[idx]
    if src.dim() == 2:
        return src[point_rows(src.shape[0], idx.dim(), src.device), idx]
    lead = src.shape[:-1]
    if idx.shape[:-1] != lead:
        lead = _broadcast(lead, idx.shape[:-1])
        src, idx = src.expand(*lead, src.shape[-1]), idx.expand(*lead, idx.shape[-1])
    return torch.gather(src, -1, idx)


def batch_state(state):
    """An unbatched state as a batch of one point (a view of each field)."""
    return state.replace(**{
        f.name: getattr(state, f.name)[None] for f in dataclasses.fields(state)
    })


def unbatch_state(state):
    """A batch of one point as an unbatched state."""
    return state.replace(**{
        f.name: getattr(state, f.name)[0] for f in dataclasses.fields(state)
    })


def is_batched(state) -> bool:
    """A batched state's round clock ``t`` is ``float32[B]``."""
    return state.t.dim() == 1


def carry_state(carry):
    """The scheduler state of a round carry: under provenance the carry is
    ``(state, Provenance)``, otherwise the state itself."""
    return carry[0] if isinstance(carry, tuple) else carry


def batch_carry(carry):
    """``batch_state`` of every part of a carry."""
    if isinstance(carry, tuple):
        return tuple(batch_state(c) for c in carry)
    return batch_state(carry)


def unbatch_carry(carry):
    """``unbatch_state`` of every part of a carry."""
    if isinstance(carry, tuple):
        return tuple(unbatch_state(c) for c in carry)
    return unbatch_state(carry)


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of a tree of dataclasses, dicts, tuples and
    lists (states, carries, task arrays, layouts, sketches, summaries);
    anything else (capacities, targets, None) passes through.  A lane or
    point of a batched tree is ``tree_map(lambda x: x[i:i + 1], tree)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


def tree_join(fn: Callable, trees: list):
    """Trees of one structure joined: ``fn`` over each tensor's list across
    them (``torch.cat`` of batches, ``torch.stack`` of unbatched trees).
    Their other leaves must agree: lanes over one shared config have the
    same capacities."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(trees)
    if isinstance(first, dict):
        return {k: tree_join(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)) and not all(
            isinstance(x, (int, float, str)) for x in first):
        return type(first)(tree_join(fn, list(xs)) for xs in zip(*trees))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: tree_join(fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)})
    if any(t != first for t in trees[1:]):
        raise ValueError(f"lanes disagree on a static field: {trees}")
    return first


def split_batch(tree, devices, per: int) -> list:
    """Entry ``e``'s contiguous slice ``[e * per, (e + 1) * per)`` of a
    batched tree, on ``devices[e]`` (a view when it is there already)."""
    return [tree_map(lambda x, e=e, d=d: x[e * per:(e + 1) * per].to(d), tree)
            for e, d in enumerate(devices)]


def gather_batch(parts: list, home: torch.device):
    """The entries' outputs joined along the batch axis on ``home``."""
    if len(parts) == 1:
        return parts[0]
    return tree_join(lambda xs: torch.cat([x.to(home) for x in xs]), parts)


# ---------------------------------------------------------------------------
# stage helpers: windowed FIFOs, launch bookkeeping, completion masks
# ---------------------------------------------------------------------------


def slice_rows(mat: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row windows: row i of the result is ``mat[i, starts[i] :
    starts[i] + width]``, over any leading axes (``mat``'s broadcast
    against ``starts``', so rows shared by every point are sliced per
    point).  The reference's ``dynamic_slice`` clamps a start that would
    leave the row; callers pad their rows by ``width`` so that never
    applies, and here an index past the row is an error of ``gather``
    rather than a silent clamp."""
    if mat.shape[-1] < width:
        raise ValueError(f"rows of width {mat.shape[-1]} cannot hold a {width}-wide window")
    idx = starts.to(torch.int64)[..., None] + torch.arange(
        width, dtype=torch.int64, device=mat.device
    )
    if mat.shape[:-1] != starts.shape:
        lead = _broadcast(mat.shape[:-1], starts.shape)
        mat, idx = mat.expand(*lead, mat.shape[-1]), idx.expand(*lead, width)
    return torch.gather(mat, -1, idx)


def sorted_fifo(queued: torch.Tensor, width: int) -> torch.Tensor:
    """Window positions of the queued entries in FIFO order (``width`` =
    none): sorting queued positions ahead of the ``width`` sentinels keeps
    task-index (== FIFO) order, so the r-th launch rank maps to
    ``sorted_fifo(...)[..., r]`` even when launched tasks punch holes."""
    pos = torch.arange(width, dtype=torch.int32, device=queued.device).expand(queued.shape)
    return torch.sort(torch.where(queued, pos, width), dim=-1).values


def pad_last(x: torch.Tensor, value) -> torch.Tensor:
    """``x`` with one slot of ``value`` appended along its last axis (per
    row of any leading axes): the pad slot a sentinel index reads."""
    return torch.cat([x, x.new_full(x.shape[:-1] + (1,), value)], dim=-1)


def finish_pad(task_finish: torch.Tensor) -> torch.Tensor:
    """``task_finish`` with a ``-inf`` pad slot so windowed gathers of the
    out-of-bounds sentinel task read as launched."""
    return pad_last(task_finish, float("-inf"))


def window_launched(fpad: torch.Tensor, wtask: torch.Tensor, num_tasks: int) -> torch.Tensor:
    """bool — which window entries are already launched (pad sentinels
    count as launched, so head advance can run through them)."""
    return ~torch.isinf(take(fpad, wtask)) | (wtask >= num_tasks)


def launched_lead(launched: torch.Tensor) -> torch.Tensor:
    """int32 — length of each window's launched prefix (the amount the
    FIFO head pointer advances this round)."""
    lead = torch.cumprod(launched.to(torch.int32), dim=-1, dtype=torch.int32)
    return torch.sum(lead, dim=-1, dtype=torch.int32)


def select_from_window(
    ranks: torch.Tensor, fifo_pos: torch.Tensor, wtask: torch.Tensor, num_tasks: int
) -> torch.Tensor:
    """Map match ranks to window task ids: rank r serves the r-th queued
    window position (``sorted_fifo``), which indexes the window's task
    ids; unmatched lanes (rank < 0) read the ``num_tasks`` sentinel.  Works
    batched ([G, C] windows with [G, K] ranks) and flat ([C] with [W])."""
    width = fifo_pos.shape[-1]
    sel_pos = torch.gather(fifo_pos, -1, ranks.clamp(0, width - 1).to(torch.int64))
    sel = torch.gather(wtask, -1, sel_pos.clamp(0, width - 1).to(torch.int64))
    return torch.where(ranks >= 0, sel, num_tasks)


def apply_launch(
    launch: torch.Tensor,
    task_pick: torch.Tensor,
    start: torch.Tensor,
    dur_pad: torch.Tensor,
    task_finish: torch.Tensor,
    worker_finish: torch.Tensor,
    worker_task: torch.Tensor,
    num_tasks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply one phase's launches ([W]-space masks, or [B, W] with
    ``start`` one per point) to the task/worker state: the completion time
    is known at launch, so ``task_finish`` and ``worker_finish`` are both
    recorded as ``start + duration``.  Lanes that launch nothing write the
    pad slot ``num_tasks``, which is cut off (the reference's
    ``mode="drop"``).  ``dur_pad`` is shared (``[T + 1]``) or one row per
    point (``[B, T + 1]``, lane-stacked windows)."""
    lt = torch.where(launch, task_pick, num_tasks).to(torch.int64)
    fin = lift(start, task_pick) + take(dur_pad, torch.clamp(task_pick, max=num_tasks))
    padded = torch.cat([task_finish, task_finish.new_zeros(task_finish.shape[:-1] + (1,))], -1)
    task_finish = padded.scatter(-1, lt, fin)[..., :num_tasks]
    worker_finish = torch.where(launch, fin, worker_finish)
    worker_task = torch.where(launch, task_pick, worker_task)
    return task_finish, worker_finish, worker_task


def rollback_heads(heads: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """FIFO heads ``[B, N]`` rolled back to the positions ``pos`` of lost
    tasks, per row ``rows`` (``[B, K]``; row N is the pad of a lane with no
    loss, cut off): the reference's dropped ``heads.at[rows].min(pos)``.
    A min does not depend on the order of repeated rows, so the result is
    the same on any device."""
    padded = torch.cat([heads, heads.new_zeros(heads.shape[:-1] + (1,))], -1)
    return padded.scatter_reduce(-1, rows, pos, "amin", include_self=True)[..., :-1]


def completion_masks(
    worker_finish: torch.Tensor, t: torch.Tensor, dt: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(free bool[W], completed-now bool[W]) ground truth at round start:
    free iff the recorded finish time has passed, completed-now iff it
    fell inside the round window just ended."""
    t = lift(t, worker_finish)
    free = worker_finish <= t
    return free, free & (worker_finish > t - dt)


def fault_stage(
    faults: FaultSchedule | None,
    t: torch.Tensor,
    dt: float,
    task_finish: torch.Tensor,
    worker_finish: torch.Tensor,
    worker_task: torch.Tensor,
    num_tasks: int,
):
    """Stage 1: the crash transition shared by every rule.  Returns
    ``(task_finish, worker_finish, lost_w, n_lost)``; with ``faults=None``
    the arrays pass through untouched and ``lost_w``/``n_lost`` are None
    (the stage is left out; rules guard their rollback on it)."""
    if faults is None:
        return task_finish, worker_finish, None, None
    return apply_worker_faults(
        faults, t, dt, task_finish, worker_finish, worker_task, num_tasks
    )


# ---------------------------------------------------------------------------
# the round pipeline
# ---------------------------------------------------------------------------

#: Dispatch stage: (state, t, task_finish0, worker_finish0, free, comp,
#: lost_w) -> dict of state-field updates (everything except t/rnd/lost,
#: which the runtime advances).  ``lost_w`` (bool[B, W], the workers whose
#: in-flight task the fault stage lost) is None without a fault schedule.
#: A dispatch built with telemetry adds a ``"telemetry"`` dict of per-round
#: int32[B] counters (``launches`` and rule extras), one built with
#: provenance a ``"provenance"`` dict (``repro_torch.simx.provenance``);
#: the runtime pops both before folding the updates.
DispatchFn = Callable[..., dict]

#: The shared counters whose per-round deltas the telemetry stage derives
#: itself: new - old of the carried ``CoreState`` counters, plus the
#: ``QueueState`` health counters for reservation-queue rules.
TELEMETRY_CORE_COUNTERS = ("messages", "probes", "inconsistencies", "lost")
TELEMETRY_QUEUE_COUNTERS = ("res_overflow", "probe_lag")

#: ``CoreState`` fields the runtime advances itself in ``compose_step``:
#: the round clock and the crash-loss counter.  A dispatch stage's update
#: dict never holds them (the runtime would fold the rule's write and then
#: advance it again); ``repro_torch.analysis.simxlint``'s SC101 reads this.
RUNTIME_OWNED_FIELDS = ("t", "rnd", "lost")

#: The stages ``compose_step`` runs, in order, with each stage's owner and
#: the state fields it writes (the reference's table; ``metrics`` is the
#: docstring's stage 6, advance).  Provenance (stage 5) writes no state
#: field: it advances the carry's ``Provenance`` beside the state, so it
#: has no row.  Data only: the linter reads it, nothing runs from it.
STAGE_TABLE = (
    # (stage,     owner,     writes)
    ("faults",    "runtime", ("task_finish", "worker_finish", "lost")),
    ("complete",  "runtime", ()),            # masks only
    ("dispatch",  "rule",    "any-but-runtime-owned"),
    ("telemetry", "runtime", ()),            # derives deltas, writes nothing
    ("metrics",   "runtime", ("t", "rnd", "lost")),
)

#: Round-index budget: ``rnd`` is int32, so a run may advance at most this
#: many rounds before the counter would wrap.
MAX_ROUND_BUDGET = 2**31 - 2**20


def check_round_budget(num_rounds: int, where: str = "scan_rounds") -> None:
    """Fail fast when a round budget would overflow the int32 round clock."""
    if num_rounds > MAX_ROUND_BUDGET:
        raise OverflowError(
            f"{where}: {num_rounds} rounds exceeds the int32 round-clock "
            f"budget ({MAX_ROUND_BUDGET}); the rnd counter would wrap "
            "silently. Split the run or raise dt."
        )


def compose_step(
    cfg: SimxConfig,
    tasks: TaskArrays,
    dispatch: DispatchFn,
    faults=None,
    telemetry: bool = False,
    provenance: bool = False,
) -> Callable:
    """Assemble one rule's round step: ``faults -> complete -> dispatch ->
    telemetry -> provenance -> advance``, on a batched carry (an unbatched
    one is lifted to one point and back).  ``faults`` (a ``FaultSchedule``,
    its leaves shared by every point or with a leading point axis) adds the
    crash stage and the ``lost`` counter; ``None`` leaves both out.

    With ``telemetry=True`` the step returns ``(carry, counters)``:
    ``counters`` merges the rule's per-round ``"telemetry"`` dict with the
    deltas of the shared state counters (``TELEMETRY_CORE_COUNTERS``, and
    ``TELEMETRY_QUEUE_COUNTERS`` for a ``QueueState``), one int32 per
    point.  With ``provenance=True`` the carry is ``(state, Provenance)``
    and the runtime advances the lifecycle arrays after folding the
    updates.  Both are decided here, in Python: without them the step is
    the one without either stage."""
    from repro_torch.simx.provenance import advance_provenance

    T = tasks.num_tasks

    def step(carry):
        s = carry[0] if provenance else carry
        if not is_batched(s):
            out = step(batch_carry(carry))
            if telemetry:
                return unbatch_carry(out[0]), {k: v[0] for k, v in out[1].items()}
            return unbatch_carry(out)
        t = s.t
        with spans.span("simx.faults"):
            task_finish0, worker_finish0, lost_w, n_lost = fault_stage(
                faults, t, cfg.dt, s.task_finish, s.worker_finish, s.worker_task, T
            )
        with spans.span("simx.complete"):
            free, comp = completion_masks(worker_finish0, t, cfg.dt)
        with spans.span("simx.dispatch"):
            updates = dispatch(s, t, task_finish0, worker_finish0, free, comp, lost_w)
        with spans.span("simx.advance"):
            tel = updates.pop("telemetry", None)
            pv = updates.pop("provenance", None)
            if n_lost is not None:
                updates["lost"] = s.lost + n_lost
            new = s.replace(t=t + cfg.dt, rnd=s.rnd + 1, **updates)
        out = new
        if provenance:
            with spans.span("simx.provenance"):
                out = (new, advance_provenance(carry[1], s, new, task_finish0, tasks, pv or {}))
        if not telemetry:
            return out
        with spans.span("simx.telemetry"):
            counters = dict(tel or {})
            for f in TELEMETRY_CORE_COUNTERS:
                counters[f] = getattr(new, f) - getattr(s, f)
            if isinstance(new, QueueState):
                for f in TELEMETRY_QUEUE_COUNTERS:
                    counters[f] = getattr(new, f) - getattr(s, f)
        return out, counters

    return step


def scan_rounds(step: Callable, state, num_rounds: int):
    """Advance a carry (a state, or ``(state, Provenance)``) by
    ``num_rounds`` rounds of a step built without telemetry (``lax.scan``
    as a loop).  An unbatched carry is lifted to one point once, not every
    round."""
    check_round_budget(num_rounds)
    if not is_batched(carry_state(state)):
        return unbatch_carry(scan_rounds(step, batch_carry(state), num_rounds))
    for i in range(num_rounds):
        with spans.span("simx.round", round_index=i):
            state = step(state)
    return state


# ---------------------------------------------------------------------------
# the rule registry
# ---------------------------------------------------------------------------


#: A rule's random draws, by name (megha's ``orders``, sparrow's probe
#: ``targets``, eagle's ``targets``/``off1``/``off2``); each may carry a
#: leading point axis.
Draws = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Rule:
    """One scheduler of the simx matrix.

    ``build_step(cfg, tasks, draws, *, match_fn, faults, telemetry,
    provenance)`` returns the round step (``faults``: a ``FaultSchedule``
    or None; ``telemetry`` / ``provenance``: the optional stages, see
    ``compose_step``);
    ``init(cfg, tasks, batch)`` the fresh state on ``tasks``' device,
    unbatched for ``batch=None`` and with ``batch`` points else.

    ``draws`` holds the rule's random draws (the reference draws them with
    ``jax.random`` when it builds the step; the port takes them as an
    argument, so the reference's can be fed in).  ``draw(cfg, tasks,
    generator)`` draws them from a ``torch.Generator`` (on the CPU, so a
    run on the card and on the CPU draw alike); ``draw_dims`` names each
    draw with its rank for one point, so a draw one rank higher carries a
    point axis.  A rule that draws nothing has neither.  ``needs_grid``
    marks rules whose worker count must divide into the GM x LM grid;
    ``has_queues`` rules carry ``[W, R]`` reservation queues.

    ``build_step`` also takes ``layout=``, the rule's layout of a streaming
    window, which ``stream_layout(cfg, win)`` builds from the window ``win``
    (``stream._StreamWindow``: its ``jobs``, ``T_cap``, ``T_real``,
    ``J_cap``, ``window_jobs``, ``device``, ``per_task`` and
    ``probe_layout``).  It returns ``(layout, fifos)``: ``fifos`` maps each
    FIFO-head field of the state to its host ``FifoRows``, whose heads a
    refill recomputes."""

    name: str
    init: Callable[..., Any]
    build_step: Callable[..., Callable]
    needs_grid: bool = False
    has_queues: bool = False
    draw: Callable[[SimxConfig, TaskArrays, torch.Generator], Draws] | None = None
    draw_dims: dict[str, int] = dataclasses.field(default_factory=dict)
    stream_layout: Callable[[SimxConfig, Any], tuple[Any, dict]] | None = None


#: name -> Rule, in registration order.
RULES: dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    """Register a scheduler rule; every entry point picks it up."""
    if rule.name in RULES:
        raise ValueError(f"rule {rule.name!r} already registered")
    RULES[rule.name] = rule
    return rule


def get_rule(name: str) -> Rule:
    try:
        return RULES[name.lower()]
    except KeyError:
        raise ValueError(
            f"the port's simx backend implements {tuple(RULES)}, not {name!r}"
        ) from None


def rule_draws(
    rule: Rule,
    cfg: SimxConfig,
    tasks: TaskArrays,
    source: Draws | torch.Tensor | torch.Generator | int | None,
) -> Draws:
    """The draws a rule's step is built with, from ``source``: a dict of
    the rule's draws as they are (fed in, e.g. the reference's), a tensor
    for a rule with one draw (megha's orders), a ``torch.Generator`` to
    draw them from, or an int seeding one (None: seed 0).  A rule that
    draws nothing gets ``{}`` whatever the source."""
    if not rule.draw_dims:
        return {}
    if isinstance(source, torch.Tensor):
        if len(rule.draw_dims) != 1:
            raise ValueError(f"{rule.name} draws {tuple(rule.draw_dims)}: pass them as a dict")
        source = {next(iter(rule.draw_dims)): source}
    if isinstance(source, dict):
        if set(source) != set(rule.draw_dims):
            raise ValueError(
                f"{rule.name} draws {tuple(rule.draw_dims)}, got {tuple(source)}")
        return source
    if source is None or isinstance(source, int):
        source = torch.Generator().manual_seed(0 if source is None else source)
    return rule.draw(cfg, tasks, source)


def orders_as_draws(orders: torch.Tensor | None, draws: Draws | None) -> Draws | None:
    """Megha's ``orders=`` argument as the ``draws`` it stands for."""
    if orders is None:
        return draws
    if draws is not None:
        raise ValueError("pass megha's orders or draws, not both")
    return {"orders": orders}


def draws_batch(rule: Rule, draws: Draws) -> int | None:
    """The point axis of ``draws`` (None when they are one point's)."""
    for name, dims in rule.draw_dims.items():
        if draws[name].dim() == dims + 1:
            return draws[name].shape[0]
    return None


def simulate_fixed(
    name: str,
    cfg: SimxConfig,
    tasks: TaskArrays,
    draws: Draws | torch.Tensor | torch.Generator | int,
    num_rounds: int,
    match_fn: MatchFn | None = None,
    faults: FaultSchedule | None = None,
    telemetry=None,
    provenance: bool = False,
):
    """Run any registered rule exactly ``num_rounds`` rounds from a fresh
    DC, with no done probe (the reference's ``simulate_fixed``), under the
    fault schedule ``faults`` if one is given.

    ``draws`` is the rule's draws or where to draw them from
    (``rule_draws``): megha's GM orders as a tensor (``int32[G, W]``, or
    ``[B, G, W]`` one set per point), a dict of any rule's draws, a
    ``torch.Generator`` or an int seeding one.  The run is batched when
    ``tasks`` carries per-point arrival times, the draws a point axis or
    the fault schedule a point axis (a Fig. 4 grid shares one trace, and
    pigeon and the oracle draw nothing), and returns a state with that
    leading axis; otherwise the state is unbatched.

    ``telemetry`` (a ``repro_torch.simx.telemetry.TelemetryConfig``)
    switches on the telemetry stage: the result becomes ``(state,
    Timeline)``.  ``provenance=True`` makes the state the ``(state,
    Provenance)`` carry (inside that tuple when both are on)."""
    rule = get_rule(name)
    draws = rule_draws(rule, cfg, tasks, draws)
    if faults is not None:
        faults = faults.to(tasks.device)
    step = rule.build_step(cfg, tasks, draws, match_fn=match_fn, faults=faults,
                           telemetry=telemetry is not None, provenance=provenance)
    batch = tasks.batch
    if batch is None:
        batch = draws_batch(rule, draws)
    if batch is None and faults is not None:
        batch = faults.batch
    state = rule.init(cfg, tasks, batch)
    if provenance:
        from repro_torch.simx.provenance import init_provenance

        state = (state, init_provenance(tasks.num_tasks, tasks.device, batch))
    if telemetry is None:
        return scan_rounds(step, state, num_rounds)
    from repro_torch.simx import telemetry as tlm  # runtime <- telemetry cycle guard

    return tlm.scan_rounds_telemetry(step, state, num_rounds, telemetry, cfg, tasks, faults)


# ---------------------------------------------------------------------------
# the shared job-delay reduction (Eq. 2)
# ---------------------------------------------------------------------------


def job_delays_from_state(
    task_finish: torch.Tensor, t: torch.Tensor, tasks: TaskArrays
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-job Eq. 2 delays from the state.

    A task is done iff its recorded finish time has passed ``t``; a job
    finishes at its last task's finish.  Returns ``(delays float32[J],
    job_finish float32[J])`` with ``delays = finish - submit - ideal``,
    nan for unfinished jobs (``job_finish`` reads ``+/-inf`` there); a
    batched ``task_finish [B, T]`` with ``t [B]`` gives ``[B, J]``."""
    fin = torch.where(task_finish <= lift(t, task_finish), task_finish, float("inf"))
    j = tasks.num_jobs
    lead = fin.shape[:-1]
    # the max-scatter gets a pad slot, as the reference's scatter drops
    # out-of-range rows (there are none: every task belongs to a job)
    job_finish = torch.full(
        lead + (j + 1,), float("-inf"), dtype=torch.float32, device=fin.device
    ).scatter_reduce(
        -1, tasks.job.to(torch.int64).expand(fin.shape), fin, "amax", include_self=True
    )[..., :j]
    delays = job_finish - tasks.job_submit - tasks.job_ideal
    delays = torch.where(torch.isfinite(job_finish), delays, float("nan"))
    return delays, job_finish
