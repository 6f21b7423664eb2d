#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no environment set:

    python3 chip_smoke.py

It builds every kernel of the main path from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the main
path — ``run_simulation(..., backend="simx")`` for megha and the oracle at
49,984 workers and 480,000 tasks — and prints one JSON line per phase:

  build        nvcc time, registers / shared memory / spills per kernel
  kernel       the kernel against its plain version over a sweep of widths,
               dtypes and n, then at the main path's shapes: error, time,
               plain time, torch.cumsum time, bytes and the byte bound
  megha_plain  kernel and plain-match runs in turns: final states bitwise
               equal, launches = rounds + borrow rounds, walls
  megha_sync   host synchronisations of one run, counted by torch
  megha        the main path through run_simulation: tasks completed,
               rounds, delays, counters, kernel launches, host syncs per
               round, wall, memory (printed after the two phases above,
               which give its rounds and syncs)
  megha_profile  torch.profiler over a steady window: device busy/idle
  oracle       the oracle on the same trace, and megha's gap above it
  cpu_parity   the port on the CPU against the port on the card, bitwise
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build, match, ref  # noqa: E402
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
    t0 = time.perf_counter()
    info = build.build("match")
    match._launch_fn()  # load it and bind the C signature
    out = dict(
        phase="build", seconds=time.perf_counter() - t0,
        kernels=[dict(name=info.name, library=info.library.name,
                      nvcc_seconds=info.nvcc_seconds, cached=info.cached,
                      ptxas=info.ptxas)],
    )
    check(len(info.ptxas) == 3, "ptxas reports the three dtype instances")
    check(all(k["spill_bytes"] == 0 for k in info.ptxas), "no register spills")
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
    phase_cpu_parity()

    borrow = next(r for r in kern["rows"] if r["caller"] == "megha_borrow")
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
    )]})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
