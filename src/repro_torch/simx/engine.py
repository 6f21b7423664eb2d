"""simx engine: the fixed-timestep simulation driven from the host (port of
``repro/simx/engine.py``, for all five rules: megha, sparrow, eagle, pigeon
and the oracle).

The round-synchronous approximation of the event backend is the
reference's, unchanged (see the ``repro.simx.engine`` docstring): within a
round completions come first, then heartbeats, then every GM matches and
every LM verifies, with conflicts arbitrated by a per-round rotating GM
priority.

The reference runs ``chunk`` rounds per jitted ``lax.scan`` and reads the
all-done probe once per chunk; the port runs the same rounds as a Python
loop and reads the probe at the same points, so the final ``t``/``rnd``
(and every delay) are the reference's.  ``simulate_workload(telemetry=,
provenance=)`` adds the optional stages (``repro_torch.simx.telemetry``,
``repro_torch.simx.provenance``) without another host read: the probe
stays the one read a chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.base import LONG_JOB_THRESHOLD, grid_workers
from repro_torch.core.metrics import JobRecord, RunMetrics, TaskRecord, classify_long
from repro_torch.device import resolve_device
from repro_torch.simx import runtime
from repro_torch.simx import telemetry as tlm
from repro_torch.simx.faults import FaultPlan, FaultSchedule, is_empty
from repro_torch.simx.provenance import Provenance, decompose_delays, init_provenance

# importing the rule modules registers them (the paper schedulers, then
# the oracle baseline), in the reference's order
from repro_torch.simx import megha as simx_megha  # noqa: F401
from repro_torch.simx import sparrow as simx_sparrow  # noqa: F401
from repro_torch.simx import eagle as simx_eagle  # noqa: F401
from repro_torch.simx import pigeon as simx_pigeon  # noqa: F401
from repro_torch.simx import oracle as simx_oracle  # noqa: F401
from repro_torch.simx.runtime import scan_rounds
from repro_torch.simx.state import CoreState, SimxConfig, TaskArrays, export_workload
from repro_torch.simx.telemetry import TelemetryConfig, Timeline
from repro_torch.workload.traces import Workload


def make_chunk_runner(step: Callable, chunk: int = 256) -> Callable:
    """A ``chunk``-round advance of ``step`` that also returns the all-done
    probe (a device bool: reading it is the caller's host sync)."""

    def run(carry):
        carry = scan_rounds(step, carry, chunk)
        return carry, all_done(carry)

    return run


def all_done(carry) -> torch.Tensor:
    """The all-done probe of a carry: every task's finish time has passed
    the clock (a device bool)."""
    s = runtime.carry_state(carry)
    return torch.all(s.task_finish <= runtime.lift(s.t, s.task_finish))


def _run_tail(step: Callable, state, n: int):
    """The final partial chunk of ``run_to_completion``: exactly ``n <
    chunk`` rounds, with the same done probe."""
    return make_chunk_runner(step, n)(state)


def run_to_completion(
    step: Callable,
    state,
    *,
    chunk: int = 256,
    max_rounds: int = 1_000_000,
):
    """Drive ``step`` in ``chunk``-round pieces until every task is done
    (or ``max_rounds``).  The done probe is read only at the end of each
    chunk, as in the reference, and a final partial chunk runs exactly
    the remainder, so the state never advances past the budget."""
    runtime.check_round_budget(max_rounds, "run_to_completion(max_rounds=...)")
    run_chunk = make_chunk_runner(step, chunk)
    rounds = 0
    while rounds < max_rounds:
        n = min(chunk, max_rounds - rounds)
        if n == chunk:
            state, done = run_chunk(state)
        else:
            state, done = _run_tail(step, state, n)
        rounds += n
        if bool(done):
            break
    return state


def run_to_completion_telemetry(
    step: Callable,
    state,
    tel: TelemetryConfig,
    cfg: SimxConfig,
    tasks: TaskArrays,
    *,
    faults: FaultSchedule | None = None,
    chunk: int = 256,
    max_rounds: int = 1_000_000,
) -> tuple:
    """Telemetry counterpart of ``run_to_completion``: drive a step built
    with telemetry (it returns ``(carry, counters)``) in chunks of whole
    telemetry windows, keeping the series on the device.  Returns
    ``(carry, Timeline)``.

    The chunk is rounded down to a multiple of ``tel.stride`` (at least
    one window), as the reference rounds it, so that the series match; a
    final partial chunk keeps ``max_rounds`` exact, its trailing ``<
    stride`` rounds advancing the state unsampled.  The done probe is
    read once a chunk, as in ``run_to_completion``."""
    runtime.check_round_budget(max_rounds, "run_to_completion_telemetry(max_rounds=...)")
    if not runtime.is_batched(runtime.carry_state(state)):
        carry, tl = run_to_completion_telemetry(
            step, runtime.batch_carry(state), tel, cfg, tasks, faults=faults,
            chunk=chunk, max_rounds=max_rounds)
        return runtime.unbatch_carry(carry), tlm.unbatch_timeline(tl)
    stride = tel.stride
    chunk = max(stride, (chunk // stride) * stride)
    sample_fn = tlm.default_sample_fn(cfg, tasks, faults)
    blocks: list[dict] = []
    rounds = 0
    while rounds < max_rounds:
        n = min(chunk, max_rounds - rounds)
        k = n // stride
        if k:
            state, series = tlm.scan_blocks(step, state, k, stride, sample_fn)
            blocks.append(series)
        if n - k * stride:
            state = tlm.advance_plain(step, state, n - k * stride)
        rounds += n
        if bool(all_done(state)):
            break
    series = ({key: torch.cat([b[key] for b in blocks], dim=-1) for key in blocks[0]}
              if blocks else {})
    return state, tlm.make_timeline(series, state, tasks, tel, cfg)


def estimate_rounds(cfg: SimxConfig, tasks: TaskArrays, slack: float = 4.0) -> int:
    """Upper-bound round count: arrival span + ``slack`` x the perfectly
    packed drain time + the longest task + one heartbeat interval.  The duration
    sum is taken in float32, as the reference takes it (torch and XLA sum
    in different orders, so the last bit of the sum can differ on
    non-integer durations; the round counts agree on the test traces)."""
    span = (
        float(torch.max(tasks.submit))
        + slack * float(torch.sum(tasks.duration)) / cfg.num_workers
        + float(torch.max(tasks.duration))
        + cfg.heartbeat_interval
        + 1.0
    )
    return int(math.ceil(span / cfg.dt))


@dataclass
class SimxRun:
    """A finished simx simulation plus everything needed to report it.
    ``borrow_rounds`` counts the rounds that ran megha's borrow pass (each
    one a second match launch); it is 0 for the other rules.  ``timeline``
    and ``provenance`` are the optional stages' results (None when the run
    was built without them)."""

    scheduler: str
    workload_name: str
    cfg: SimxConfig
    tasks: TaskArrays
    state: CoreState
    borrow_rounds: int = 0
    timeline: Optional[Timeline] = None
    provenance: Optional[Provenance] = None

    @property
    def end_time(self) -> float:
        return float(self.state.t)

    @property
    def tasks_completed(self) -> int:
        return int(torch.sum(self.state.task_finish <= self.state.t))

    @property
    def lost_tasks(self) -> int:
        """In-flight tasks lost to worker crashes (each re-ran elsewhere)."""
        return int(self.state.lost)

    def job_finish_times(self) -> np.ndarray:
        """float64[J] job finish (max task finish; nan if any task is
        unfinished), through the runtime's shared reduction."""
        _, job_finish = runtime.job_delays_from_state(
            self.state.task_finish, self.state.t, self.tasks
        )
        out = job_finish.cpu().numpy().astype(np.float64)
        return np.where(np.isfinite(out), out, np.nan)

    def job_delays(self) -> np.ndarray:
        """float64[J] JCT delay (Eq. 2) for completed jobs, nan otherwise."""
        delays, _ = runtime.job_delays_from_state(
            self.state.task_finish, self.state.t, self.tasks
        )
        return delays.cpu().numpy().astype(np.float64)

    def _need_provenance(self) -> Provenance:
        if self.provenance is None:
            raise ValueError(
                "run was built without provenance (simulate_workload(..., provenance=True))")
        return self.provenance

    def delay_decomposition(self) -> dict[str, np.ndarray]:
        """Per-job delay split into the four provenance components (each
        float64[J], nan for unfinished jobs), summing to ``job_delays()``.
        Requires ``simulate_workload(provenance=True)``."""
        d = decompose_delays(self._need_provenance(), self.state.task_finish, self.state.t,
                             self.tasks, self.cfg.dt)
        return {k: v.cpu().numpy().astype(np.float64) for k, v in d.items()}

    def span_events(self, pid: int = 1) -> list[dict]:
        """Chrome trace ``ph: "X"`` duration spans of this run's tasks on
        per-GM and per-worker tracks (``telemetry.provenance_spans``).
        Requires ``simulate_workload(provenance=True)``."""
        return tlm.provenance_spans(self._need_provenance(), self.state, self.tasks, self.cfg,
                                    pid=pid, name=self.scheduler)

    def to_run_metrics(self) -> RunMetrics:
        """Materialize ``RunMetrics`` records so event-backend consumers
        (``summary()``, percentile helpers) work unchanged.  One Python
        object per job and task: a known cost at 500k tasks."""
        m = RunMetrics(scheduler=self.scheduler, workload=self.workload_name)
        m.inconsistencies = int(self.state.inconsistencies)
        m.repartitions = int(self.state.repartitions)
        m.messages = int(self.state.messages)
        m.probes = int(self.state.probes)
        job_finish = self.job_finish_times().tolist()
        submit = self.tasks.job_submit.cpu().numpy().astype(np.float64).tolist()
        ideal = self.tasks.job_ideal.cpu().numpy().astype(np.float64).tolist()
        ntasks = self.tasks.job_ntasks.cpu().numpy().tolist()
        for j in range(self.tasks.num_jobs):
            m.jobs.append(
                JobRecord(
                    job_id=j,
                    submit_time=submit[j],
                    ideal_jct=ideal[j],
                    num_tasks=ntasks[j],
                    finish_time=job_finish[j],
                    is_long=classify_long(ideal[j], LONG_JOB_THRESHOLD),
                )
            )
        # late-binding paths queue at the worker, centrally scheduled ones
        # at the scheduling entity; eagle splits per task: short jobs ride
        # the probe path, long jobs the central FIFO (the event backend's
        # d_queue_* bookkeeping)
        t_job_np = self.tasks.job.cpu().numpy()
        if self.scheduler == "sparrow":
            worker_queue = np.ones(self.tasks.num_tasks, bool)
        elif self.scheduler == "eagle":
            worker_queue = self.tasks.job_est.cpu().numpy()[t_job_np] < self.cfg.long_threshold
        else:
            worker_queue = np.zeros(self.tasks.num_tasks, bool)
        worker_queue = worker_queue.tolist()
        t_job = t_job_np.tolist()
        t_dur = self.tasks.duration.cpu().numpy().astype(np.float64)
        t_sub = self.tasks.submit.cpu().numpy().astype(np.float64)
        t_fin_raw = self.state.task_finish.cpu().numpy().astype(np.float64)
        # finish was recorded at launch as start + duration
        t_start = t_fin_raw - t_dur
        t_fin = np.where(t_fin_raw <= self.end_time, t_fin_raw, np.inf)
        hops = 3 * self.cfg.hop
        t_dur, t_sub = t_dur.tolist(), t_sub.tolist()
        t_start, t_fin = t_start.tolist(), t_fin.tolist()
        for i in range(self.tasks.num_tasks):
            started = math.isfinite(t_start[i])
            tr = TaskRecord(
                job_id=t_job[i],
                task_index=i,
                duration=t_dur[i],
                submit_time=t_sub[i],
                start_time=t_start[i] if started else math.nan,
                finish_time=t_fin[i] if math.isfinite(t_fin[i]) else math.nan,
            )
            if started:
                pre = max(0.0, t_start[i] - t_sub[i])
                tr.d_comm = min(pre, hops)
                if worker_queue[i]:
                    tr.d_queue_worker = pre - tr.d_comm
                else:
                    tr.d_queue_scheduler = pre - tr.d_comm
            m.tasks.append(tr)
        return m


def simulate_workload(
    scheduler: str,
    workload: Workload,
    num_workers: int,
    *,
    num_gms: int = 8,
    num_lms: int = 8,
    heartbeat_interval: float = 5.0,
    probe_ratio: int = 2,
    long_threshold: float = LONG_JOB_THRESHOLD,
    short_partition_fraction: float = 0.10,
    num_distributors: int = 5,
    group_size: int = 40,
    reserved_per_group: int = 2,
    weight: int = 4,
    reserve_cap: int = 0,
    probe_window: int = 0,
    dt: float = 0.05,
    seed: int = 0,
    chunk: int = 256,
    max_rounds: Optional[int] = None,
    until: Optional[float] = None,
    use_kernel: bool = True,
    orders: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    device=None,
    faults: FaultSchedule | FaultPlan | None = None,
    telemetry: TelemetryConfig | bool | None = None,
    provenance: bool = False,
) -> SimxRun:
    """Run one (scheduler, workload) simx simulation to completion on
    ``device`` (``None`` = the CUDA card).

    ``scheduler`` is any registered rule: ``"megha"``, ``"sparrow"``,
    ``"eagle"``, ``"pigeon"`` or ``"oracle"``.  ``until`` caps the
    simulated time span instead of running until all tasks finish.  The
    knobs carry the event backend's names and the reference's defaults
    (``weight`` maps to ``SimxConfig.wfq_weight``; ``reserve_cap`` /
    ``probe_window`` size the sparrow/eagle reservation queues, 0 = auto).
    ``use_kernel`` selects the rank-and-select kernel (the default) or its
    plain version.  The rule's random draws are ``draws`` (a dict, e.g.
    sparrow's ``targets``) or, for megha, ``orders`` (int32[G, W]); without
    them they are drawn from a ``torch.Generator`` seeded with ``seed``.

    ``faults`` injects a fault schedule (a dense ``FaultSchedule`` for the
    run's worker and GM counts, or a backend-neutral ``FaultPlan``) into
    the round step; an empty one builds the fault-free step.  Outages park
    work until recovery, so without ``max_rounds`` the round cap grows past
    the last finite recovery by a heartbeat interval, as in the
    reference.

    ``telemetry`` (a ``TelemetryConfig``, or ``True`` for the defaults)
    collects the decimated series and the delay histogram into
    ``SimxRun.timeline``; ``provenance=True`` carries the per-task
    lifecycle arrays into ``SimxRun.provenance`` (``delay_decomposition()``,
    ``span_events()``).  Without them the run is the one without either
    stage, bitwise."""
    dev = resolve_device(device)
    name = scheduler.lower()
    rule = runtime.get_rule(name)
    tasks = export_workload(workload, dev)
    if rule.needs_grid:
        num_workers = grid_workers(num_workers, num_gms, num_lms)
    cfg = SimxConfig(
        num_workers=num_workers,
        num_gms=num_gms,
        num_lms=num_lms,
        heartbeat_interval=heartbeat_interval,
        probe_ratio=probe_ratio,
        long_threshold=long_threshold,
        short_partition_fraction=short_partition_fraction,
        num_distributors=num_distributors,
        group_size=group_size,
        reserved_per_group=reserved_per_group,
        wfq_weight=weight,
        reserve_cap=reserve_cap,
        probe_window=probe_window,
        dt=dt,
    )
    if isinstance(faults, FaultPlan):
        faults = faults.to_schedule(num_workers, num_gms, dt, device=dev)
    if faults is not None:
        if tuple(faults.worker_down.shape) != (num_workers,):
            raise ValueError(
                f"fault schedule covers {faults.worker_down.shape[0]} workers, "
                f"simulation has {num_workers} (megha shaves to the GM x LM "
                "grid — build the schedule from grid_workers(num_workers))"
            )
        if rule.needs_grid and tuple(faults.gm_down.shape) != (num_gms,):
            raise ValueError(
                f"fault schedule covers {faults.gm_down.shape[0]} GMs, "
                f"simulation has {num_gms}"
            )
        if is_empty(faults):
            faults = None  # the no-op schedule: build the fault-free step
        else:
            faults = faults.to(dev)
    draws = runtime.orders_as_draws(orders, draws)
    if telemetry is True:
        telemetry = TelemetryConfig()
    step = rule.build_step(
        cfg, tasks, runtime.rule_draws(rule, cfg, tasks, seed if draws is None else draws),
        match_fn=runtime.default_match_fn(use_kernel), faults=faults,
        telemetry=telemetry is not None, provenance=provenance,
    )
    state = rule.init(cfg, tasks)
    if provenance:
        state = (state, init_provenance(tasks.num_tasks, dev))
    cap = max_rounds if max_rounds is not None else estimate_rounds(cfg, tasks)
    if max_rounds is None and faults is not None:
        # outages park work until recovery: extend the horizon past the last
        # finite recovery plus a drain allowance for the re-run tasks
        ups = torch.cat([faults.worker_up.reshape(-1), faults.gm_up.reshape(-1)])
        finite = ups[torch.isfinite(ups)]
        if finite.numel():
            cap += int(math.ceil(float(finite.max()) / dt)) + cfg.heartbeat_rounds
    if until is not None:
        cap = min(cap, int(math.ceil(until / dt)))
    timeline = prov = None
    if telemetry is None:
        state = run_to_completion(step, state, chunk=chunk, max_rounds=cap)
    else:
        state, timeline = run_to_completion_telemetry(
            step, state, telemetry, cfg, tasks, faults=faults, chunk=chunk, max_rounds=cap)
    if provenance:
        state, prov = state
    return SimxRun(
        scheduler=name,
        workload_name=workload.name,
        cfg=cfg,
        tasks=tasks,
        state=state,
        borrow_rounds=getattr(step, "borrow_rounds", 0),
        timeline=timeline,
        provenance=prov,
    )
