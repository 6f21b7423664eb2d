"""In-run telemetry for the simx rules: decimated per-round time series,
the job-delay histogram, Chrome traces, and the P² streaming quantile
sketch (port of ``repro/simx/telemetry.py``).

  * ``TelemetryConfig`` — the decimation ``stride`` (one sample per
    ``stride`` rounds) and the fixed-bin delay-histogram shape.
  * ``Timeline`` — the collected series: a time axis ``t[K]``, a dict of
    ``[K]`` series (per-window counter sums and end-of-window gauges) and
    the job-delay histogram ``delay_hist[bins]``.  A batched run stacks a
    leading point axis onto every leaf, as the reference's ``vmap`` does.
  * ``scan_rounds_telemetry`` — the decimated loop: windows of
    ``stride`` rounds of a step built with ``compose_step(...,
    telemetry=True)``, whose per-round counters are summed per window.
  * ``to_chrome_trace`` / ``provenance_spans`` — Chrome trace events
    (counter tracks, and per-task wait and run spans from a
    ``Provenance``), host Python over the finished arrays.

Every counter and sample stays a tensor on the run's device until the run
ends: the collection adds no host read to the round loop.  The reference's
``lax.scan`` over windows becomes a Python loop, and its stacked ``ys`` a
``torch.stack`` of the window tensors.

**The P² sketch** (``QuantileSketch``, Jain & Chlamtac 1985): one
5-marker cell per target quantile, O(Q) state however many observations
it absorbed.  The streaming engine (``repro_torch.simx.stream``) absorbs
each segment's retired-job delays into it.  The sketch lives on the run's
device (``sketch_init(device=)``) and its functions read nothing to the
host.  ``sketch_absorb`` here is the plain version, one observation at a
time in the reference's float32 order; the hand-written kernel of the
same recursion is ``repro_torch.kernels.p2.p2_absorb``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.simx import runtime
from repro_torch.simx.faults import FaultSchedule, worker_dead
from repro_torch.simx.state import SimxConfig, TaskArrays, spec

_I32, _I64 = torch.int32, torch.int64


@dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry parameters.

    ``stride`` decimates the series: one sample per ``stride`` rounds —
    counter keys hold the sum over the window, gauge keys the value at the
    window's end.  ``delay_bins`` x ``delay_max`` shape the job-delay
    histogram (bin width ``delay_max / delay_bins``; delays past
    ``delay_max`` clamp into the last bin, unfinished jobs are left out).
    """

    stride: int = 8
    delay_bins: int = 32
    delay_max: float = 60.0

    def __post_init__(self) -> None:
        if self.stride < 1:
            raise ValueError("telemetry stride must be >= 1")
        if self.delay_bins < 1:
            raise ValueError("delay_bins must be >= 1")

    @property
    def bin_width(self) -> float:
        return self.delay_max / self.delay_bins


@dataclass(frozen=True)
class Timeline:
    """One simulation's collected telemetry (a batch of them, with a
    leading point axis on every tensor, for a batched run).

    ``series`` keys split into counters (per-window sums of per-round
    deltas: ``launches``, ``messages``, ``probes``, ``inconsistencies``,
    ``lost``, rule extras, and for reservation-queue rules
    ``res_overflow`` / ``probe_lag``) and gauges sampled at each window's
    end (``utilization``, ``pending`` / ``running`` / ``completed`` task
    counts, ``queue_depth`` = jobs with pending work, ``live_workers``).
    ``t[k]`` is the simulated time at the end of window k.  A trailing
    partial window advances the state but is not sampled."""

    t: torch.Tensor = spec("float32[K]")  # simulated time per sample
    series: dict                           # str -> [K] tensor (counters + gauges)
    delay_hist: torch.Tensor = spec("int32[B]")  # finished-job delay histogram
    stride: int = 1
    dt: float = 0.05
    delay_max: float = 60.0

    @property
    def num_samples(self) -> int:
        return int(self.t.shape[-1])

    @property
    def bin_edges(self) -> np.ndarray:
        """float64[bins + 1] — delay-histogram bin edges (last bin clamps)."""
        b = self.delay_hist.shape[-1]
        return np.linspace(0.0, self.delay_max, b + 1)

    def to_chrome_trace(self, pid: int = 1, process_name: Optional[str] = None) -> dict:
        """Serialize to the Chrome trace event format: one counter track
        (``"ph": "C"``) per series key, timestamps in microseconds of
        simulated time; dumps straight to a JSON file loadable in
        ``chrome://tracing`` / Perfetto."""
        ts = np.asarray(self.t.cpu(), np.float64) * 1e6          # sim-seconds -> us
        events: list[dict] = []
        if process_name is not None:
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process_name},
            })
        for key in sorted(self.series):
            vals = np.asarray(self.series[key].cpu(), np.float64)
            for k in range(vals.shape[-1]):
                events.append({
                    "name": key, "ph": "C", "pid": pid, "tid": 0,
                    "ts": float(ts[k]), "args": {key: float(vals[k])},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# provenance span tracing (Chrome "X" duration events)
# ---------------------------------------------------------------------------


#: tid offset for per-worker execution tracks (scheduler tracks sit at
#: ``1 + gm``, workers at ``WORKER_TID_BASE + worker``)
WORKER_TID_BASE = 1000


def provenance_spans(
    prov,
    state,
    tasks: TaskArrays,
    cfg: SimxConfig,
    pid: int = 1,
    name: Optional[str] = None,
    max_tasks: Optional[int] = None,
) -> list[dict]:
    """Chrome trace duration events (``"ph": "X"``) from a single run's
    ``Provenance``.  Each finished task gives a wait span on its placing
    scheduler's track (``tid = 1 + gm``, submit -> launch) and a run span
    on its worker's track (``tid = WORKER_TID_BASE + worker``, start ->
    finish); thread-name metadata labels both track families.
    ``max_tasks`` keeps the first N finished tasks."""
    from repro_torch.simx.provenance import UNSET

    def host(x):
        return x.detach().cpu().numpy()

    tf = np.asarray(host(state.task_finish), np.float64)
    end_t = float(state.t)
    dur = np.asarray(host(tasks.duration), np.float64)
    sub = np.asarray(host(tasks.submit), np.float64)
    job = host(tasks.job)
    launch_r = host(prov.launch_round)
    gm = host(prov.placed_gm)
    worker = host(prov.placed_worker)
    requeue = host(prov.requeue_count)
    stale = host(prov.stale_retry_count)
    done = (tf <= end_t) & (launch_r != UNSET) & (worker != UNSET)
    ids = np.nonzero(done)[0]
    if max_tasks is not None:
        ids = ids[:max_tasks]

    events: list[dict] = []
    if name is not None:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
    for g in sorted({int(gm[i]) for i in ids} | ({0} if not ids.size else set())):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 1 + g,
            "args": {"name": f"gm{g}"},
        })
    for w in sorted({int(worker[i]) for i in ids}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": WORKER_TID_BASE + w, "args": {"name": f"worker{w}"},
        })
    for i in ids:
        start = tf[i] - dur[i]                      # recorded at launch
        label = f"job{int(job[i])}/task{int(i)}"
        args = {
            "job": int(job[i]), "task": int(i),
            "requeues": int(requeue[i]), "stale_retries": int(stale[i]),
        }
        wait = max(0.0, start - sub[i])
        events.append({
            "name": f"{label} wait", "ph": "X", "pid": pid,
            "tid": 1 + int(gm[i]), "ts": sub[i] * 1e6, "dur": wait * 1e6,
            "args": args,
        })
        events.append({
            "name": label, "ph": "X", "pid": pid,
            "tid": WORKER_TID_BASE + int(worker[i]),
            "ts": start * 1e6, "dur": dur[i] * 1e6, "args": args,
        })
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return events


# ---------------------------------------------------------------------------
# shared gauges + the delay histogram
# ---------------------------------------------------------------------------


def default_sample_fn(
    cfg: SimxConfig,
    tasks: TaskArrays,
    faults: Optional[FaultSchedule] = None,
) -> Callable:
    """The gauge sampler the decimated loop runs at each window's end on
    a batched state: the rule-independent observables, from the state
    alone.  With ``faults``, dead workers count neither as busy nor in
    ``live_workers``."""
    W = cfg.num_workers
    J = tasks.num_jobs
    job64 = tasks.job.to(_I64)

    def sample(s) -> dict:
        t = runtime.lift(s.t, s.worker_finish)
        busy = s.worker_finish > t                                 # bool[B, W]
        if faults is not None:
            dead = worker_dead(faults, s.t)
            busy = busy & ~dead                                    # down != working
            live = W - torch.sum(dead, dim=-1, dtype=_I32)
        else:
            live = torch.full_like(s.rnd, W)
        tt = runtime.lift(s.t, s.task_finish)
        done = s.task_finish <= tt
        launched = ~torch.isinf(s.task_finish)
        pend = ~launched & (tasks.submit <= tt)                    # arrived, unlaunched
        B = pend.shape[0]
        pend_job = torch.zeros((B, J), dtype=torch.uint8, device=pend.device).scatter_reduce(
            -1, job64.expand(B, -1), pend.to(torch.uint8), "amax", include_self=True)
        return {
            "utilization": torch.sum(busy, dim=-1, dtype=torch.float32) / W,
            "pending": torch.sum(pend, dim=-1, dtype=_I32),
            "running": torch.sum(launched & ~done, dim=-1, dtype=_I32),
            "completed": torch.sum(done, dim=-1, dtype=_I32),
            "queue_depth": torch.sum(pend_job, dim=-1, dtype=_I32),
            "live_workers": live,
        }

    return sample


def delay_histogram(
    task_finish: torch.Tensor, t: torch.Tensor, tasks: TaskArrays, tel: TelemetryConfig
) -> torch.Tensor:
    """int32[..., delay_bins] — fixed-bin histogram of finished-job delays
    (Eq. 2, through the runtime's shared reduction) from the final state;
    delays past ``delay_max`` clamp into the last bin, unfinished jobs go
    to a pad bin that is cut off (the reference's dropped scatter)."""
    delays, _ = runtime.job_delays_from_state(task_finish, t, tasks)
    b = tel.delay_bins
    idx = torch.floor(delays / tel.bin_width).to(_I32)
    idx = torch.where(torch.isfinite(delays), torch.clamp(idx, 0, b - 1), b).to(_I64)
    lead = delays.shape[:-1]
    hist = torch.zeros(lead + (b + 1,), dtype=_I32, device=delays.device)
    return hist.scatter_add(-1, idx, torch.ones_like(idx, dtype=_I32))[..., :b]


# ---------------------------------------------------------------------------
# streaming quantile sketch (P², fixed state)
# ---------------------------------------------------------------------------

#: default steady-state reporting quantiles (median + the tail family)
DEFAULT_QUANTILES = (0.5, 0.95, 0.99, 0.999)


def _marker_fracs(targets: tuple) -> np.ndarray:
    """Desired marker positions after n observations are ``1 + (n - 1) *
    frac`` with frac = [0, p/2, p, (1 + p)/2, 1]."""
    p = np.asarray(targets, np.float32)[:, None]
    return np.concatenate(
        [np.zeros_like(p), p / 2, p, (1 + p) / 2, np.ones_like(p)], axis=1
    )


@dataclass(frozen=True)
class QuantileSketch:
    """P² streaming quantile state: one 5-marker cell per target quantile.
    The first 5 observations fill ``buf`` (exact order statistics); the
    5th bootstraps the markers, after which the P² marker-adjustment
    recursion runs.  A lane-batched sketch (``sketch_init(lanes=L)``, the
    sharded steady state's) carries a leading ``[L]`` axis on every
    tensor: L independent sketches absorbed together."""

    q: torch.Tensor = spec("float32[Q, 5]")    # marker heights
    n: torch.Tensor = spec("float32[Q, 5]")    # integer marker pos (1-based)
    npd: torch.Tensor = spec("float32[Q, 5]")  # desired marker positions
    dn: torch.Tensor = spec("float32[Q, 5]")   # per-obs desired increment
    buf: torch.Tensor = spec("float32[5]")     # warm-up buffer (first 5 obs)
    count: torch.Tensor = spec("int32[]")      # observations absorbed
    targets: tuple = DEFAULT_QUANTILES


def sketch_init(targets: tuple = DEFAULT_QUANTILES, device=None,
                lanes: Optional[int] = None) -> QuantileSketch:
    """A fresh sketch for ``targets`` (quantiles in (0, 1)) on ``device``
    (None: the CPU, torch's default); marker positions start at their
    bootstrap values, so the update is defined while the warm-up buffer
    fills.  ``lanes`` gives every tensor a leading axis of that many
    independent sketches."""
    if not targets or min(targets) <= 0.0 or max(targets) >= 1.0:
        raise ValueError("quantile targets must lie strictly in (0, 1)")
    fr = _marker_fracs(tuple(targets))
    qn = fr.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    sk = QuantileSketch(
        q=torch.zeros((qn, 5), **f32),
        n=torch.arange(1.0, 6.0, **f32).expand(qn, 5).clone(),
        npd=torch.from_numpy((1.0 + 4.0 * fr).astype(np.float32)).to(device),
        dn=torch.from_numpy(fr.astype(np.float32)).to(device),
        buf=torch.zeros(5, **f32),
        count=torch.zeros((), dtype=_I32, device=device),
        targets=tuple(targets),
    )
    return sk if lanes is None else runtime.tree_join(torch.stack, [sk] * int(lanes))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 as one fused multiply-add: the product of
    two float32 values is exact in float64, so the sum is rounded once
    there and once to float32 (the two roundings can differ from one only
    on a float64 sum that falls on a float32 halfway point)."""
    return (a.double() * b.double() + c.double()).float()


def _p2_markers(q, n, npd, dn, x):
    """One P² marker-adjustment step for observation ``x`` on bootstrapped
    ``[Q, 5]`` marker state, in the reference's operation order.  The
    reference runs it compiled, and XLA on the CPU contracts the two
    ``qi + m * y`` updates into fused multiply-adds; so does this."""
    q = q.clone()
    q[:, 0] = torch.minimum(q[:, 0], x)                    # new minimum
    q[:, 4] = torch.maximum(q[:, 4], x)                    # new maximum
    # cell index k in [0, 3]: number of markers <= x, shifted/clipped
    k = torch.clamp(torch.sum(q <= x, dim=1) - 1, 0, 3)
    n = n + (torch.arange(5, device=q.device)[None, :] > k[:, None]).to(torch.float32)
    npd = npd + dn
    # the three interior markers in order: marker i's move sees i - 1's
    # updated position
    for i in (1, 2, 3):
        d = npd[:, i] - n[:, i]
        gap_up = n[:, i + 1] - n[:, i]
        gap_dn = n[:, i - 1] - n[:, i]
        move = torch.where(
            (d >= 1.0) & (gap_up > 1.0), 1.0,
            torch.where((d <= -1.0) & (gap_dn < -1.0), -1.0, 0.0),
        ).to(torch.float32)
        qi, qu, ql = q[:, i], q[:, i + 1], q[:, i - 1]
        ni, nu, nl = n[:, i], n[:, i + 1], n[:, i - 1]
        q_par = _fma(move / (nu - nl), (
            (ni - nl + move) * (qu - qi) / (nu - ni)
            + (nu - ni - move) * (qi - ql) / (ni - nl)
        ), qi)
        q_lin = _fma(move, torch.where(
            move >= 0.0, (qu - qi) / (nu - ni), (ql - qi) / (nl - ni)
        ), qi)
        q_new = torch.where(
            move != 0.0,
            torch.where((ql < q_par) & (q_par < qu), q_par, q_lin),
            qi,
        )
        q = q.clone()
        n = n.clone()
        q[:, i] = q_new
        n[:, i] = ni + move
    return q, n, npd


def sketch_update(sk: QuantileSketch, x, valid) -> QuantileSketch:
    """Absorb one observation ``x`` when ``valid``; otherwise the state
    passes through untouched.  Nothing is read to the host: the warm-up
    buffer's write is a select on its slot ``count`` (no slot matches once
    the buffer is full)."""
    dev = sk.q.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    cnt = sk.count
    buf = torch.where(torch.arange(5, device=dev) == cnt, x, sk.buf)
    # bootstrap (exactly at the 5th observation): sorted buffer -> markers
    boot_q = torch.sort(buf).values.expand(sk.q.shape)
    q2, n2, npd2 = _p2_markers(sk.q, sk.n, sk.npd, sk.dn, x)
    is_boot = cnt == 4
    is_run = cnt >= 5
    new = (
        torch.where(is_boot, boot_q, torch.where(is_run, q2, sk.q)),
        torch.where(is_run, n2, sk.n),
        torch.where(is_run, npd2, sk.npd),
        buf,
        cnt + 1,
    )
    valid = torch.as_tensor(valid, device=dev)
    q, n, npd, buf, count = (torch.where(valid, a, b) for a, b in zip(
        new, (sk.q, sk.n, sk.npd, sk.buf, sk.count)))
    return QuantileSketch(q=q, n=n, npd=npd, dn=sk.dn, buf=buf, count=count.to(_I32),
                          targets=sk.targets)


def sketch_absorb(sk: QuantileSketch, values, mask) -> QuantileSketch:
    """Absorb a batch: ``values[i]`` is observed iff ``mask[i]`` (the
    reference's ``lax.scan`` over the batch, as a loop).  The plain version
    of the ``p2_sketch`` kernel: about 80 small ops per value.  A
    lane-batched sketch takes ``[L, N]`` values and mask and absorbs each
    lane's row into its own sketch, one lane after another."""
    dev = sk.q.device
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    if sk.count.dim() == 1:
        return runtime.tree_join(torch.stack, [
            sketch_absorb(runtime.tree_map(lambda x, i=i: x[i], sk), values[i], mask[i])
            for i in range(sk.count.shape[0])])
    for x, v in zip(values, mask):
        sk = sketch_update(sk, x, v)
    return sk


def sketch_quantiles(sk: QuantileSketch) -> torch.Tensor:
    """float32[Q] — the current estimates (P² center markers; exact order
    statistics of the warm-up buffer below 5 observations; NaN with none);
    ``[L, Q]`` for a lane-batched sketch."""
    cnt = sk.count[..., None]
    p = sk.dn[..., 2]               # the targets as float32 (frac column p)
    # small-sample path: nearest rank on the sorted valid prefix of buf
    pad = torch.where(torch.arange(5, device=cnt.device) < cnt, sk.buf, float("inf"))
    rank = torch.clamp(torch.round(p * (cnt - 1)).to(_I32), 0, 4)
    small = torch.gather(torch.sort(pad).values, -1, rank.to(_I64))
    est = torch.where(cnt >= 5, sk.q[..., 2], small)
    return torch.where(cnt > 0, est, float("nan"))


# ---------------------------------------------------------------------------
# the decimated loop
# ---------------------------------------------------------------------------


def advance_plain(step: Callable, carry, num_rounds: int):
    """Advance a batched carry ``num_rounds`` rounds of a telemetry step
    (which returns ``(carry, counters)``), discarding the counters: the
    trailing partial window."""
    for _ in range(num_rounds):
        carry = step(carry)[0]
    return carry


def scan_blocks(step: Callable, carry, num_blocks: int, stride: int, sample_fn: Callable):
    """``num_blocks`` windows of ``stride`` rounds of a telemetry step on a
    batched carry.  Per window the per-round counters are summed to one
    int32 per point and key, then the gauges are sampled from the
    window-end state.  Returns ``(carry, series)``, ``series`` a dict of
    ``[B, num_blocks]`` tensors including ``"t"`` (an empty dict for no
    window); nothing leaves the device."""
    blocks = []
    for _ in range(num_blocks):
        acc = None
        for _ in range(stride):
            carry, counters = step(carry)
            acc = counters if acc is None else {k: acc[k] + v for k, v in counters.items()}
        s = runtime.carry_state(carry)
        out = dict(acc)
        out.update(sample_fn(s))
        out["t"] = s.t
        blocks.append(out)
    series = {k: torch.stack([b[k] for b in blocks], dim=-1) for k in blocks[0]} if blocks else {}
    return carry, series


def make_timeline(series: dict, carry, tasks: TaskArrays, tel: TelemetryConfig,
                  cfg: SimxConfig) -> Timeline:
    """The ``Timeline`` of a finished batched run from its window series
    (``scan_blocks``' dicts joined along the window axis)."""
    s = runtime.carry_state(carry)
    series = dict(series)
    t_axis = series.pop("t", None)
    if t_axis is None:
        t_axis = torch.zeros(s.t.shape + (0,), dtype=torch.float32, device=s.t.device)
    return Timeline(
        t=t_axis,
        series=series,
        delay_hist=delay_histogram(s.task_finish, s.t, tasks, tel),
        stride=tel.stride,
        dt=cfg.dt,
        delay_max=tel.delay_max,
    )


def unbatch_timeline(tl: Timeline) -> Timeline:
    """A batch of one point's ``Timeline`` as that point's."""
    return dataclasses.replace(
        tl, t=tl.t[0], series={k: v[0] for k, v in tl.series.items()},
        delay_hist=tl.delay_hist[0])


def scan_rounds_telemetry(
    step: Callable,
    state,
    num_rounds: int,
    tel: TelemetryConfig,
    cfg: SimxConfig,
    tasks: TaskArrays,
    faults: Optional[FaultSchedule] = None,
) -> tuple:
    """Telemetry counterpart of ``runtime.scan_rounds``: advance a carry
    exactly ``num_rounds`` rounds of a step built with
    ``compose_step(..., telemetry=True)``, collecting the decimated series,
    then bin the final job delays.  Returns ``(carry, Timeline)``; an
    unbatched carry is lifted to one point and back."""
    runtime.check_round_budget(num_rounds)
    if not runtime.is_batched(runtime.carry_state(state)):
        carry, tl = scan_rounds_telemetry(
            step, runtime.batch_carry(state), num_rounds, tel, cfg, tasks, faults)
        return runtime.unbatch_carry(carry), unbatch_timeline(tl)
    K = num_rounds // tel.stride
    rem = num_rounds - K * tel.stride
    sample_fn = default_sample_fn(cfg, tasks, faults)
    state, series = scan_blocks(step, state, K, tel.stride, sample_fn)
    if rem:
        state = advance_plain(step, state, rem)
    return state, make_timeline(series, state, tasks, tel, cfg)
