#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no environment set:

    python3 chip_smoke.py

It builds every kernel of the port's paths from the sources in the
checkout (one ``nvcc`` per source, all started together), holds each
against its plain PyTorch version on the card, drives the paths —
``run_simulation(..., backend="simx")`` for megha and the oracle at 49,984
workers and 480,000 tasks, the Megha serving engine at 49,984 slots with
200,000 requests, and the fast path's SDPS loop — and prints one JSON line
per phase:

  build        nvcc time, registers / shared memory / spills per kernel
  kernel       the batched kernel against its plain version over a sweep of
               widths, dtypes and n, then at the main path's shapes: error,
               time, plain time, torch.cumsum time, bytes and the byte bound
  kernel_single  the single-row kernel (both entry points, match_ranks and
               the fused match_tasks) likewise, at the serving and SDPS
               shapes
  megha_plain  kernel and plain-match runs in turns: final states bitwise
               equal, launches = rounds + borrow rounds, walls
  megha_sync   host synchronisations of one run, counted by torch
  megha        the main path through run_simulation: tasks completed,
               rounds, delays, counters, kernel launches, host syncs per
               round, wall, memory (printed after the two phases above,
               which give its rounds and syncs)
  megha_profile  torch.profiler over a steady window: device busy/idle
  oracle       the oracle on the same trace, and megha's gap above it
  serve        the serving engine (8 frontends x 8 pods x 6,248 slots),
               kernel and plain engines in turns: identical stats and final
               state, every request completed, gm_round calls == kernel
               launches, host syncs per tick, wall, memory
  serve_profile  a steady window of serving ticks under torch.profiler:
               device busy and idle share, host time in torch ops; and the
               SDPS loop's gm_round likewise
  sdps         the fast path's scheduling decisions per second at 9,984 and
               49,984 workers, kernel and plain; the event backend's megha
  cpu_parity   the port on the CPU against the port on the card, bitwise
               (megha, the oracle and the serving engine)
  kernels      one summary line per kernel

then the card's name and power limit (``nvidia-smi``) and, as the last
line, the device line.  Any failed check raises, and the script exits
non-zero without printing the device line; it also fails when no card is
found.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import fastpath as FP  # noqa: E402
from repro_torch.kernels import build, match, ops, ref  # noqa: E402
from repro_torch.serve.engine import MeghaServeEngine, Request  # noqa: E402
from repro_torch.sim.simulator import run_simulation  # noqa: E402
from repro_torch.simx import convert, runtime, simulate_workload  # noqa: E402
from repro_torch.simx.state import SimxConfig, export_workload  # noqa: E402
from repro_torch.workload.synth import synthetic_trace  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor FP32
#: operations/s, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: The paper-scale Fig. 2 point: 480 jobs x 1000 one-second tasks at load
#: 0.8 on 50,000 workers (megha shaves to 49,984 on its 8 x 8 grid).
TRACE = dict(num_jobs=480, tasks_per_job=1000, load=0.8, num_workers=50_000, seed=0)
WORKERS = 50_000
DT = 0.05
GRID_WORKERS = 49_984
DEVICE = "cuda"

SWEEP_WIDTHS = (1, 100, 128, 1024, 8192, 50_000)
SWEEP_DTYPES = (torch.int8, torch.int32, torch.bool)

#: The main path's match shapes at the paper scale (8 GMs, 8 LMs).
MAIN_SHAPES = (
    ("megha_internal", 8, GRID_WORKERS // 8),
    ("megha_borrow", 8, GRID_WORKERS),
    ("oracle", 1, WORKERS),
)

#: The serving engine at the paper's 50k-worker fleet on the 8 x 8 grid:
#: 8 frontends (GMs) over 8 pods (LMs) of 6,248 slots, 49,984 slots in all.
SERVE = dict(num_frontends=8, num_pods=8, slots_per_pod=6248, max_batch=512,
             heartbeat_ticks=16)
SERVE_REQUESTS = 200_000
SERVE_ARRIVAL = 3000.0   # Poisson requests per tick: ~80 % occupancy at
SERVE_MEAN_GEN = 12      # 1 + Poisson(12) ticks of decode per request
MAX_TASKS = 512          # the serving batch and the SDPS batch

#: The single-row kernel's shapes: the serving engine and SDPS at 49,984,
#: SDPS at 9,984, and the widths of benchmarks/bench_kernels.py.
SINGLE_SHAPES = (
    ("serve_sdps", GRID_WORKERS),
    ("sdps", 9984),
    ("bench_kernels", 8192),
    ("bench_kernels", 65536),
)
SDPS_WORKERS = (10_000, 50_000)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, iters: int = 200) -> float:
    """Device time of one call of ``fn``, from CUDA events around
    ``iters`` warm calls.  A spin kernel holds the stream while the calls
    are enqueued, so the events time the device's work back to back and
    not the host's launch overhead."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host wall time of one call of ``fn`` (launch overhead included),
    over ``iters`` calls ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def states_equal(a, b) -> bool:
    na, nb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return all(
        na[k].dtype == nb[k].dtype and na[k].shape == nb[k].shape
        and np.array_equal(na[k], nb[k])
        for k in na
    )


def completed(metrics) -> int:
    return sum(1 for t in metrics.tasks if t.finish_time == t.finish_time)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    """Both sources at once, one nvcc each, then load and bind them."""
    t0 = time.perf_counter()
    names = ("match", "match_tasks")
    with ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build.build, names)))
    match._launch_fn()  # load each library and bind its C signature
    match._single_fns()
    out = dict(
        phase="build", seconds=time.perf_counter() - t0,
        kernels=[dict(name=i.name, library=i.library.name,
                      nvcc_seconds=i.nvcc_seconds, cached=i.cached,
                      ptxas=i.ptxas) for i in infos.values()],
    )
    check(len(infos["match"].ptxas) == 3, "ptxas reports the three dtype instances")
    check(len(infos["match_tasks"].ptxas) == 6,
          "ptxas reports three dtypes x two entry points of match_tasks.cu")
    check(all(k["spill_bytes"] == 0 for i in infos.values() for k in i.ptxas),
          "no register spills")
    emit(out)
    return out


def phase_kernel(gen: torch.Generator) -> dict:
    """The sweep, then the main-path shapes; returns the per-shape rows."""
    cases, worst = 0, 0
    for w in SWEEP_WIDTHS:
        for dtype in SWEEP_DTYPES:
            avail = (torch.rand((4, w), generator=gen) < 0.4).to(dtype).to(DEVICE)
            for n in (
                torch.tensor([0, 1, w // 2, w], dtype=torch.int32),
                torch.randint(0, w + 1, (4,), generator=gen, dtype=torch.int32),
            ):
                n = n.to(DEVICE)
                got = match.match_ranks_batched(avail, n)
                want = ref.match_ranks_batched_ref(avail, n)
                torch.cuda.synchronize()
                worst = max(worst, int((got - want).abs().max()))
                check(torch.equal(got, want), f"kernel == plain at w={w} {dtype}")
                cases += 1
            row = match.match_ranks_batched(avail[1:2].contiguous(), torch.tensor(
                [w // 2], dtype=torch.int32, device=DEVICE))
            check(torch.equal(row, ref.match_ranks_batched_ref(
                avail[1:2], torch.tensor([w // 2], dtype=torch.int32, device=DEVICE))),
                f"single row at w={w} {dtype}")
            cases += 1
    emit(dict(phase="kernel", check="sweep", cases=cases, max_abs_err=worst,
              widths=list(SWEEP_WIDTHS), dtypes=[str(d) for d in SWEEP_DTYPES]))

    rows = []
    for caller, g, w in MAIN_SHAPES:
        # bool views as the main path passes them; n = w per row, so every
        # row is scanned to its end (no early exit) and the bound counts
        # every byte
        avail = (torch.rand((g, w), generator=gen) < 0.5).to(DEVICE)
        n = torch.full((g,), w, dtype=torch.int32, device=DEVICE)
        got = match.match_ranks_batched(avail, n)
        want = ref.match_ranks_batched_ref(avail, n)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel == plain at {caller} [{g}, {w}]")
        nbytes = g * w * (avail.element_size() + 4) + 4 * g
        ops = g * w
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3
        r = dict(
            phase="kernel", caller=caller, shape=[g, w], dtype="bool",
            max_abs_err=err,
            ms=device_ms(lambda: match.match_ranks_batched(avail, n)),
            plain_ms=device_ms(lambda: ref.match_ranks_batched_ref(avail, n)),
            library_ms=device_ms(
                lambda: torch.cumsum(avail, dim=1, dtype=torch.int32)),
            host_us=host_us(lambda: match.match_ranks_batched(avail, n)),
            plain_host_us=host_us(lambda: ref.match_ranks_batched_ref(avail, n)),
            bytes=nbytes, bound_ms=bound_ms, bound_by="bytes",
        )
        emit(r)
        rows.append(r)
    return dict(sweep_cases=cases, sweep_err=worst, rows=rows)


def phase_megha(wl) -> dict:
    match.match_ranks_batched.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = run_simulation("megha", wl, num_workers=WORKERS, backend="simx", dt=DT,
                       device=DEVICE)
    wall = time.perf_counter() - t0
    launches = match.match_ranks_batched.launches
    s = m.summary()
    out = dict(
        phase="megha", entry="run_simulation", workers=GRID_WORKERS,
        tasks=wl.num_tasks, completed=completed(m),
        p50_delay=s["all_median_delay"], p95_delay=s["all_p95_delay"],
        inconsistencies=m.inconsistencies, repartitions=m.repartitions,
        messages=m.messages, kernel_launches=launches, entry_wall_s=wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    check(out["completed"] == wl.num_tasks, "megha completes every task")
    check(launches > 0, "megha launched the kernel")
    return out  # emitted by main once rounds and syncs are known


def _timed_run(wl, use_kernel: bool):
    """One simulate_workload run; returns (run, wall seconds, launches)."""
    before = match.match_ranks_batched.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = simulate_workload("megha", wl, WORKERS, dt=DT, use_kernel=use_kernel,
                            device=DEVICE)
    torch.cuda.synchronize()
    return run, time.perf_counter() - t0, match.match_ranks_batched.launches - before


def phase_megha_plain(wl, entry: dict) -> dict:
    """Kernel and plain runs in turns (kernel, plain, plain, kernel, kernel,
    plain): every final state bitwise equal, walls from one card."""
    walls = {True: [], False: []}
    launches = {True: [], False: []}
    runs = []
    for use_kernel in (True, False, False, True, True, False):
        run, wall, n = _timed_run(wl, use_kernel)
        walls[use_kernel].append(wall)
        launches[use_kernel].append(n)
        runs.append(run)
    run_k = runs[0]
    rounds = int(run_k.state.rnd)
    wall_k = float(np.median(walls[True]))
    wall_p = float(np.median(walls[False]))
    out = dict(
        phase="megha_plain", rounds=rounds, borrow_rounds=run_k.borrow_rounds,
        kernel_launches=launches[True][0],
        plain_run_launches=max(launches[False]),
        bitwise_equal=all(states_equal(run_k.state, r.state) for r in runs[1:]),
        counters_equal_entry=(
            int(run_k.state.inconsistencies) == entry["inconsistencies"]
            and int(run_k.state.repartitions) == entry["repartitions"]
            and int(run_k.state.messages) == entry["messages"]),
        walls_s=walls[True], plain_walls_s=walls[False],
        wall_s=wall_k, plain_wall_s=wall_p,
        ms_per_round=wall_k / rounds * 1e3, plain_ms_per_round=wall_p / rounds * 1e3,
        tasks_per_wall_s=wl.num_tasks / wall_k,
    )
    check(set(launches[True]) == {rounds + run_k.borrow_rounds},
          "launches == rounds + borrow rounds")
    check(launches[True][0] == entry["kernel_launches"], "same launches as the entry run")
    check(out["plain_run_launches"] == 0, "the plain run launches no kernel")
    check(out["bitwise_equal"], "kernel and plain final states are bitwise equal")
    check(out["counters_equal_entry"], "the entry run and this run agree")
    emit(out)
    return out


def phase_megha_sync(wl) -> dict:
    """Host synchronisations of one whole run, counted by torch's
    sync-debug mode (one warning per synchronising call)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run = simulate_workload("megha", wl, WORKERS, dt=DT, device=DEVICE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    rounds = int(run.state.rnd)
    chunks = -(-rounds // 256)
    out = dict(phase="megha_sync", host_syncs=syncs, rounds=rounds,
               host_syncs_per_round=syncs / rounds,
               expected_round_loop_syncs=rounds + chunks)
    check(syncs >= rounds + chunks, "sync-debug mode counted the round loop")
    emit(out)
    return out


def _device_busy(prof) -> tuple[float, list, dict]:
    """Device busy µs (the union of the kernels' intervals), the intervals,
    and device ms by kernel name, from a torch.profiler run."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, -float("inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us, spans, by_name


def _profile_window(wl, use_kernel: bool, start: int, length: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = SimxConfig(num_workers=GRID_WORKERS, dt=DT)
    tasks = export_workload(wl, DEVICE)
    rule = runtime.get_rule("megha")
    step = rule.build_step(cfg, tasks, torch.Generator().manual_seed(0),
                           match_fn=runtime.default_match_fn(use_kernel))
    state = runtime.scan_rounds(step, rule.init(cfg, tasks), start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runtime.scan_rounds(step, state, length)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runtime.scan_rounds(step, state, length)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans, by_name = _device_busy(prof)
    mk = [v for k, v in by_name.items() if "match_ranks_batched_kernel" in k]
    n_mk = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "match_ranks_batched_kernel" in e.name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        phase="megha_profile", match="kernel" if use_kernel else "plain",
        rounds=[start, start + length],
        wall_ms_per_round=wall_ms / length,
        profiled_wall_ms_per_round=prof_wall_ms / length,
        device_busy_ms_per_round=busy_us / 1e3 / length,
        # busy time from the profiled pass over the wall of the same
        # rounds run without the profiler, which slows the host
        device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
        device_idle_share_profiled=1.0 - busy_us / 1e3 / prof_wall_ms,
        device_ops_per_round=len(spans) / length,
        match_kernel_launches=n_mk,
        match_kernel_us_per_launch=(sum(mk) * 1e3 / n_mk) if n_mk else None,
        top_device_ms=[[k[:90], v] for k, v in top],
    )


def phase_megha_profile(wl) -> list[dict]:
    out = []
    for use_kernel in (True, False):
        r = _profile_window(wl, use_kernel, start=128, length=64)
        check(r["device_ops_per_round"] > 0, "the profiler saw device work")
        if use_kernel:
            check(r["match_kernel_launches"] >= 64, "the window ran the kernel")
        emit(r)
        out.append(r)
    return out


def phase_oracle(wl, megha: dict) -> dict:
    match.match_ranks_batched.launches = 0
    t0 = time.perf_counter()
    m = run_simulation("oracle", wl, num_workers=WORKERS, backend="simx", dt=DT,
                       device=DEVICE)
    wall = time.perf_counter() - t0
    s = m.summary()
    out = dict(
        phase="oracle", entry="run_simulation", workers=WORKERS,
        completed=completed(m), p50_delay=s["all_median_delay"],
        p95_delay=s["all_p95_delay"],
        gap_p50=megha["p50_delay"] - s["all_median_delay"],
        gap_p95=megha["p95_delay"] - s["all_p95_delay"],
        kernel_launches=match.match_ranks_batched.launches, entry_wall_s=wall,
    )
    check(out["completed"] == wl.num_tasks, "the oracle completes every task")
    check(out["kernel_launches"] > 0, "the oracle launched the kernel")
    check(out["gap_p50"] >= -1e-9 and out["gap_p95"] >= -1e-9,
          "the oracle lower-bounds megha")
    emit(out)
    return out


def phase_cpu_parity() -> dict:
    wl = synthetic_trace(num_jobs=24, tasks_per_job=128, load=0.8,
                         num_workers=1024, seed=1)
    out = dict(phase="cpu_parity")
    for name in ("megha", "oracle"):
        runs = {
            dev: simulate_workload(name, wl, 1024, dt=0.02, device=dev)
            for dev in ("cpu", DEVICE)
        }
        out[name] = dict(
            bitwise_equal=states_equal(runs["cpu"].state, runs[DEVICE].state),
            rounds=int(runs[DEVICE].state.rnd),
            borrow_rounds=runs[DEVICE].borrow_rounds,
            completed=runs[DEVICE].tasks_completed, tasks=wl.num_tasks,
        )
        check(out[name]["bitwise_equal"], f"{name}: CPU and card states bitwise equal")
        check(out[name]["completed"] == wl.num_tasks, f"{name}: completes")
    # the serving engine at 4 frontends x 4 pods x 64 slots, same seed
    engines = {}
    for dev in ("cpu", DEVICE):
        eng = MeghaServeEngine(num_frontends=4, num_pods=4, slots_per_pod=64, seed=0,
                               device=dev)
        rng = np.random.default_rng(0)
        eng.submit([Request(i, gen_len=int(rng.integers(1, 20))) for i in range(1500)])
        eng.run_until_drained()
        engines[dev] = eng
    out["serve"] = dict(
        bitwise_equal=_engine_states_equal(_engine_state(engines["cpu"]),
                                           _engine_state(engines[DEVICE])),
        ticks=engines[DEVICE].stats.ticks, gm_rounds=engines[DEVICE].gm_rounds,
        summary=engines[DEVICE].stats.summary(),
    )
    check(out["serve"]["bitwise_equal"], "serve: CPU and card engines bitwise equal")
    check(out["serve"]["summary"]["completed"] == 1500, "serve: completes")
    emit(out)
    return out


def _single_row_cases(gen: torch.Generator):
    """Rows of the single-row sweep: (w, dtype, avail on the card)."""
    for w in SWEEP_WIDTHS:
        for dtype in SWEEP_DTYPES:
            yield w, dtype, (torch.rand((w,), generator=gen) < 0.4).to(dtype).to(DEVICE)


def phase_kernel_single(gen: torch.Generator) -> dict:
    """The single-row kernel: both entry points against their plain versions
    over the sweep, then timed at the serving and SDPS shapes."""
    cases, worst = 0, 0
    for w, dtype, avail in _single_row_cases(gen):
        for n in (0, 1, w // 2, w, w + 7):
            # n by value, then from the device
            for count in (n, torch.tensor(n, dtype=torch.int32, device=DEVICE)):
                got = match.match_ranks(avail, count)
                want = ref.match_ranks_ref(avail, n)
                worst = max(worst, int((got - want).abs().max()))
                check(torch.equal(got, want), f"match_ranks == plain at w={w} {dtype} n={n}")
                cases += 1
                for max_tasks in (MAX_TASKS, w):
                    a, p = match.match_tasks(avail, count, max_tasks)
                    wa, wp = ref.match_tasks_ref(avail, min(n, max_tasks), max_tasks)
                    torch.cuda.synchronize()
                    if a.numel():
                        worst = max(worst, int((a - wa).abs().max()))
                    worst = max(worst, abs(int(p) - int(wp)))
                    check(torch.equal(a, wa) and torch.equal(p, wp),
                          f"match_tasks == plain at w={w} {dtype} n={n} max_tasks={max_tasks}")
                    cases += 1
    emit(dict(phase="kernel_single", check="sweep", cases=cases, max_abs_err=worst,
              widths=list(SWEEP_WIDTHS), dtypes=[str(d) for d in SWEEP_DTYPES],
              n=["0", "1", "w/2", "w", "w+7"], max_tasks=[MAX_TASKS, "w"]))

    rows = []
    for caller, w in SINGLE_SHAPES:
        # bool views as gm_round passes them, half the lanes free, and the
        # serving / SDPS batch n = max_tasks = 512
        avail = (torch.rand((w,), generator=gen) < 0.5).to(DEVICE)
        n = MAX_TASKS
        a, p = match.match_tasks(avail, n, MAX_TASKS)
        wa, wp = ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)
        r_got, r_want = match.match_ranks(avail, n), ref.match_ranks_ref(avail, n)
        err = max(int((a - wa).abs().max()), abs(int(p) - int(wp)),
                  int((r_got - r_want).abs().max()))
        check(err == 0, f"single-row kernel == plain at {caller} [{w}]")
        # bytes the fused match must move: the lanes up to the n-th free one
        # (no later lane can change the result), the assignment and the count
        need_lanes = int(torch.nonzero(avail)[n - 1]) + 1 if int(wp) == n else w
        tasks_bytes = need_lanes + 4 * MAX_TASKS + 4
        ranks_bytes = w * (avail.element_size() + 4)
        r = dict(
            phase="kernel_single", caller=caller, shape=[w], dtype="bool", n=n,
            max_tasks=MAX_TASKS, max_abs_err=err,
            ms=device_ms(lambda: match.match_tasks(avail, n, MAX_TASKS)),
            plain_ms=device_ms(lambda: ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)),
            library_ms=device_ms(lambda: torch.cumsum(avail, dim=0, dtype=torch.int32)),
            host_us=host_us(lambda: match.match_tasks(avail, n, MAX_TASKS)),
            plain_host_us=host_us(
                lambda: ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)),
            bytes=tasks_bytes, bytes_if_every_lane_read=w + 4 * MAX_TASKS + 4,
            bound_ms=max(tasks_bytes / HBM_BYTES_PER_S,
                         need_lanes / SCALAR_OPS_PER_S) * 1e3,
            bound_by="bytes",
            ranks_ms=device_ms(lambda: match.match_ranks(avail, n)),
            ranks_plain_ms=device_ms(lambda: ref.match_ranks_ref(avail, n)),
            ranks_host_us=host_us(lambda: match.match_ranks(avail, n)),
            ranks_bytes=ranks_bytes,
            ranks_bound_ms=max(ranks_bytes / HBM_BYTES_PER_S, w / SCALAR_OPS_PER_S) * 1e3,
        )
        emit(r)
        rows.append(r)
    return dict(sweep_cases=cases, sweep_err=worst, rows=rows)


def _serve_engine_run(use_kernel: bool, sync_debug: bool = False):
    """One serving run at the full fleet: Poisson(3000) arrivals a tick,
    lengths 1 + Poisson(12), until 200,000 requests are in, then a drain.
    Returns (engine, wall seconds, host syncs counted by torch or None)."""
    eng = MeghaServeEngine(**SERVE, use_kernel=use_kernel, device=DEVICE)
    rng = np.random.default_rng(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            rid = 0
            while rid < SERVE_REQUESTS:
                n = min(int(rng.poisson(SERVE_ARRIVAL)), SERVE_REQUESTS - rid)
                eng.submit([Request(rid + i, gen_len=1 + int(rng.poisson(SERVE_MEAN_GEN)))
                            for i in range(n)])
                rid += n
                eng.tick()
            eng.run_until_drained()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught) if sync_debug else None
    return eng, wall, syncs


def _engine_state(eng) -> dict:
    return dict(
        truth=eng.truth.cpu(), views=torch.stack(eng.views).cpu(),
        running=sorted((s, r.rid) for s, r in eng.running.items()),
        stats=eng.stats, gm_rounds=eng.gm_rounds,
    )


def _engine_states_equal(a: dict, b: dict) -> bool:
    return (torch.equal(a["truth"], b["truth"]) and torch.equal(a["views"], b["views"])
            and a["running"] == b["running"] and a["stats"] == b["stats"]
            and a["gm_rounds"] == b["gm_rounds"])


def phase_serve() -> dict:
    """The serving path: the kernel engine's run is the one whose launches
    count; then kernel and plain engines in turns (kernel, plain, plain,
    kernel, kernel, plain): identical stats and final state; then one run
    under torch's sync-debug mode for the host syncs."""
    match.match_tasks.launches = 0
    match.match_ranks.launches = 0
    match.match_ranks_batched.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng, wall, _ = _serve_engine_run(True)
    launches = dict(match_tasks=match.match_tasks.launches,
                    match_ranks=match.match_ranks.launches,
                    match_ranks_batched=match.match_ranks_batched.launches)
    mem = torch.cuda.max_memory_allocated()
    ref_state = _engine_state(eng)
    s = eng.stats.summary()
    check(s["completed"] == SERVE_REQUESTS == s["placed"],
          "the engine completes every submitted request")
    check(launches["match_tasks"] == eng.gm_rounds > 0,
          "gm_round calls == single-row kernel launches")
    check(launches["match_ranks_batched"] == 0, "the serving path runs no batched match")

    walls = {True: [], False: []}
    equal = True
    for use_kernel in (True, False, False, True, True, False):
        before = match.match_tasks.launches
        e, w, _ = _serve_engine_run(use_kernel)
        walls[use_kernel].append(w)
        n_launch = match.match_tasks.launches - before
        check(n_launch == (e.gm_rounds if use_kernel else 0),
              "kernel engines launch once per round, plain engines never")
        equal = equal and _engine_states_equal(ref_state, _engine_state(e))
    check(equal, "kernel and plain engines: identical stats and final state")
    sync_eng, _, syncs = _serve_engine_run(True, sync_debug=True)
    check(syncs >= 2 * sync_eng.gm_rounds, "sync-debug mode counted the host reads")

    out = dict(
        phase="serve", entry="MeghaServeEngine.tick", slots=eng.w, **SERVE,
        requests=SERVE_REQUESTS, arrival_per_tick=SERVE_ARRIVAL, mean_gen=SERVE_MEAN_GEN,
        submitted=SERVE_REQUESTS, completed=s["completed"], summary=s,
        ticks=eng.stats.ticks, gm_rounds=eng.gm_rounds,
        gm_rounds_per_tick=eng.gm_rounds / eng.stats.ticks, kernel_launches=launches,
        wall_s=wall, requests_per_wall_s=SERVE_REQUESTS / wall,
        walls_s=walls[True], plain_walls_s=walls[False],
        median_wall_s=float(np.median(walls[True])),
        plain_median_wall_s=float(np.median(walls[False])),
        kernel_and_plain_identical=equal,
        host_syncs=syncs, host_syncs_per_tick=syncs / sync_eng.stats.ticks,
        host_syncs_per_gm_round=syncs / sync_eng.gm_rounds,
        max_memory_allocated=mem,
    )
    emit(out)
    return out


def _host_op_split(prof) -> tuple[float, int, list]:
    """Host µs inside top-level torch ops (dispatch, launches and the waits
    of host reads), their number, and the top ops by that time, from a
    torch.profiler run; the rest of the wall is Python outside torch."""
    from torch.autograd import DeviceType

    total, count, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.cpu_parent is not None:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        count += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    return total, count, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def _serve_ticks(eng, rng, ticks: int) -> None:
    for _ in range(ticks):
        n = int(rng.poisson(SERVE_ARRIVAL))
        eng.submit([Request(i, gen_len=1 + int(rng.poisson(SERVE_MEAN_GEN))) for i in range(n)])
        eng.tick()


def phase_serve_profile() -> dict:
    """Where a steady serving tick's time goes: 30 warm ticks, then ticks
    30-40 timed without the profiler and, on an identical engine, under
    torch.profiler (device busy, host time in torch ops); then five SDPS
    loop iterations at 49,984 workers under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = dict(phase="serve_profile", ticks=[30, 40])
    walls = []
    for profiled in (False, True):
        eng = MeghaServeEngine(**SERVE, device=DEVICE)
        rng = np.random.default_rng(1)
        _serve_ticks(eng, rng, 30)
        torch.cuda.synchronize()
        rounds0 = eng.gm_rounds
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _serve_ticks(eng, rng, 10)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            _serve_ticks(eng, rng, 10)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rounds = eng.gm_rounds - rounds0
    busy_us, spans, by_name = _device_busy(prof)
    host_us, host_ops, top_host = _host_op_split(prof)
    out.update(
        gm_rounds=rounds, wall_ms_per_tick=walls[0] * 1e2,
        profiled_wall_ms_per_tick=prof_wall * 1e2,
        device_busy_ms_per_tick=busy_us / 1e4,
        device_idle_share=1.0 - busy_us / 1e6 / walls[0],
        device_ops_per_tick=len(spans) / 10,
        torch_op_host_ms_per_tick=host_us / 1e4, torch_ops_per_tick=host_ops / 10,
        torch_op_host_share_profiled=host_us / 1e6 / prof_wall,
        top_host_ms=[[k[:60], v / 1e3] for k, v in top_host],
        top_device_ms=[[k[:90], v] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:6]],
    )
    check(out["device_ops_per_tick"] > 0, "the profiler saw the serving ticks' device work")

    workers = SDPS_WORKERS[-1] // 64 * 64
    orders = FP.make_orders(workers, 8, 8, seed=0, device=DEVICE)
    truth = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    FP.gm_round(truth, truth, orders[0], MAX_TASKS, max_tasks=MAX_TASKS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            FP.gm_round(truth, truth, orders[i], MAX_TASKS, max_tasks=MAX_TASKS)
            FP.gm_round(truth, truth, orders[i], 0, max_tasks=MAX_TASKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, spans, _ = _device_busy(prof)
    host_us, host_ops, top_host = _host_op_split(prof)
    out["sdps_gm_round"] = dict(
        workers=workers, rounds=10, profiled_wall_ms_per_round=wall * 1e2,
        device_busy_ms_per_round=busy_us / 1e4, device_ops_per_round=len(spans) / 10,
        torch_op_host_ms_per_round=host_us / 1e4, torch_ops_per_round=host_ops / 10,
        top_host_ms=[[k[:60], v / 1e3] for k, v in top_host],
    )
    emit(out)
    return out


def _fastpath_sdps(workers: int, use_kernel: bool, rounds: int = 20) -> float:
    """``benchmarks/bench_sdps.py::_fastpath_sdps`` on the port: rounds of
    512 decisions on an all-free fleet, ending in a synchronize.  Both
    rounds of the loop take ``use_kernel`` (the reference's second, n = 0,
    round takes the default path)."""
    workers = (workers // 64) * 64  # divisible into the 8x8 partition grid
    orders = FP.make_orders(workers, 8, 8, seed=0, device=DEVICE)
    truth = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    view = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    n = MAX_TASKS
    r = FP.gm_round(truth, view, orders[0], n, max_tasks=MAX_TASKS, use_kernel=use_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = 0
    for i in range(rounds):
        r = FP.gm_round(truth, view, orders[i % 8], n, max_tasks=MAX_TASKS,
                        use_kernel=use_kernel)
        decisions += n
        # free everything again so the pool never empties
        truth = FP.gm_round(truth, view, orders[i % 8], 0, max_tasks=MAX_TASKS,
                            use_kernel=use_kernel).truth
    torch.cuda.synchronize()
    check(int((r.workers >= 0).sum()) == n, "every SDPS round places its batch")
    return decisions / (time.perf_counter() - t0)


def phase_sdps() -> dict:
    out = dict(phase="sdps", rounds=20, batch=MAX_TASKS, fastpath=[])
    match.match_tasks.launches = 0
    launches = 0
    for workers in SDPS_WORKERS:
        sdps = {True: [], False: []}
        for use_kernel in (True, False, False, True, True, False):
            before = match.match_tasks.launches
            sdps[use_kernel].append(_fastpath_sdps(workers, use_kernel))
            n_launch = match.match_tasks.launches - before
            check(n_launch == (41 if use_kernel else 0),
                  "SDPS: one launch per gm_round with the kernel, none without")
            launches += n_launch
        out["fastpath"].append(dict(
            workers=(workers // 64) * 64, decisions_per_s=sdps[True],
            plain_decisions_per_s=sdps[False],
            median_decisions_per_s=float(np.median(sdps[True])),
            plain_median_decisions_per_s=float(np.median(sdps[False])),
        ))
    out["kernel_launches"] = launches
    wl = synthetic_trace(num_jobs=40, tasks_per_job=200, load=0.7, num_workers=2048)
    t0 = time.perf_counter()
    m = run_simulation("megha", wl, num_workers=2048)
    wall = time.perf_counter() - t0
    check(completed(m) == wl.num_tasks, "the event backend completes every task")
    out["event_sim"] = dict(backend="events", workers=2048, tasks=len(m.tasks),
                            wall_s=wall, tasks_per_wall_s=len(m.tasks) / wall,
                            inconsistencies=m.inconsistencies,
                            repartitions=m.repartitions, messages=m.messages)
    emit(out)
    return out


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    emit(dict(phase="env", python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0)))

    phase_build()
    kern = phase_kernel(gen)
    single = phase_kernel_single(gen)
    wl = synthetic_trace(**TRACE)
    megha = phase_megha(wl)
    plain = phase_megha_plain(wl, megha)
    sync = phase_megha_sync(wl)
    megha.update(
        rounds=plain["rounds"], borrow_rounds=plain["borrow_rounds"],
        launches_equal_rounds_plus_borrow=(
            megha["kernel_launches"] == plain["rounds"] + plain["borrow_rounds"]),
        host_syncs=sync["host_syncs"], host_syncs_per_round=sync["host_syncs_per_round"],
    )
    emit(megha)
    phase_megha_profile(wl)
    orc = phase_oracle(wl, megha)
    serve = phase_serve()
    phase_serve_profile()
    sdps = phase_sdps()
    phase_cpu_parity()

    borrow = next(r for r in kern["rows"] if r["caller"] == "megha_borrow")
    fleet = next(r for r in single["rows"] if r["caller"] == "serve_sdps")
    emit({"kernels": [dict(
        name="match_ranks_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/match.cu",
        replaces="src/repro/kernels/match.py:31",
        launches=megha["kernel_launches"],
        launches_by_path=dict(megha=megha["kernel_launches"],
                              oracle=orc["kernel_launches"]),
        max_abs_err=max(kern["sweep_err"], *(r["max_abs_err"] for r in kern["rows"])),
        shape=borrow["shape"], ms=borrow["ms"], plain_ms=borrow["plain_ms"],
        bound_ms=borrow["bound_ms"], bound_by=borrow["bound_by"],
        library_ms=borrow["library_ms"],
        library_call="torch.cumsum (the scan alone)",
        by_shape=[{k: r[k] for k in ("caller", "shape", "ms", "plain_ms",
                                     "library_ms", "bound_ms")}
                  for r in kern["rows"]],
    ), dict(
        name="match_ranks", route="cuda",
        source="src/repro_torch/kernels/csrc/match_tasks.cu",
        replaces="src/repro/kernels/match.py:97",
        entry="match_tasks (match_ranks with the inverse scatter fused in)",
        launches=serve["kernel_launches"]["match_tasks"]
        + serve["kernel_launches"]["match_ranks"],
        launches_by_path=dict(serve=serve["kernel_launches"]["match_tasks"],
                              sdps=sdps["kernel_launches"]),
        max_abs_err=max(single["sweep_err"], *(r["max_abs_err"] for r in single["rows"])),
        shape=fleet["shape"], ms=fleet["ms"], plain_ms=fleet["plain_ms"],
        bound_ms=fleet["bound_ms"], bound_by=fleet["bound_by"],
        library_ms=fleet["library_ms"],
        library_call="torch.cumsum (the scan alone)",
        by_shape=[{k: r[k] for k in ("caller", "shape", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "ranks_ms", "ranks_bound_ms")}
                  for r in single["rows"]],
    )]})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
