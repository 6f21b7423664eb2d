"""One run of one cell: set-up, the timed window of whole grids, the traced
stretch, the comparison with the plain reference, the result line.

Everything of one cell is found by name, so that a later cell needs files
and entries only:

* ``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
* ``portbench/configs/<config>.json`` (the file the manifest names) holds
  the deployment, and its ``scheduler`` names the plain reference
  ``portbench/references/<scheduler>.py``;
* ``portbench/traffic/<traffic>.json`` holds the mix, read by
  ``traffic.build``;
* ``portbench/metrics/<metric>.py`` reads one metric (``read(ctx)``, None
  when there is nothing to read);
* ``portbench/checks/<cell>.json`` holds the points the reference checks
  and the limit of each compared number (``judge``).

The window drives the program's Fig. 2 grid entry, ``sweep.sweep_grid``'s
two stages as it calls them (``grid_state``: ``build_grid`` then
``runtime.scan_rounds``; then ``point_summary``), on the CUDA match
(``runtime.default_match_fn(True)``), whole grids back to back; it keeps the
final state of the last grid for the comparison.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import devtrace, judge, traffic as traffic_mod

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: rounds of the warm-up grid (all jobs queued at once: megha's second round
#: borrows, so every shape of the window is launched)
WARM_ROUNDS = 4
#: the traced stretch: first round and length (shortened for short runs)
TRACE_START, TRACE_ROUNDS = 128, 64


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are JAX
    or the JAX package, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def reader(self, metric: str):
        return _load_module(self.bench_dir / "metrics" / f"{metric}.py",
                            f"portbench_metric_{metric}")

    def reference(self):
        sched = self.cfg["scheduler"]
        return _load_module(self.bench_dir / "references" / f"{sched}.py",
                            f"portbench_reference_{sched}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    manifest = traffic_mod.load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench_dir = root / "portbench"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        cfg=traffic_mod.load_json(root / configs[w["config"]]["file"]),
        traffic=traffic_mod.load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        checks=traffic_mod.load_json(bench_dir / "checks" / f"{workload}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)],
        bench_dir=bench_dir,
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run of ``cell`` from ``seed`` on ``device``; ``marks`` holds the
    set-up's clock readings so far (``start`` at process start)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, marks: dict):
        from repro_torch.simx import runtime, sweep
        from repro_torch.simx.state import SimxConfig

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.marks = marks
        self.sweep, self.runtime = sweep, runtime
        fields = {f.name for f in dataclasses.fields(SimxConfig)}
        self.scfg = SimxConfig(**{k: v for k, v in cell.cfg.items() if k in fields})
        self.match_fn = runtime.default_match_fn(True)
        self.probe = devtrace.MatchProbe(self.match_fn)

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.simx.state import TaskArrays

        dev = self.device
        if dev.type == "cuda":
            from repro_torch.kernels import build

            build.load("match")
        self.marks["kernel_load"] = time.perf_counter()
        self.inputs = traffic_mod.build(self.cell.cfg, self.cell.traffic, self.seed, dev)
        inp = self.inputs
        # a job's ideal completion (Eq. 2) and estimate: its longest task
        longest = torch.zeros_like(inp.job_submit[0]).scatter_reduce(
            0, inp.job.to(torch.int64), inp.duration, "amax", include_self=False)
        self.tasks = TaskArrays(
            job=inp.job, duration=inp.duration, submit=inp.submit[0],
            job_submit=inp.job_submit[0], job_ideal=longest, job_ntasks=inp.job_ntasks,
            job_est=longest.clone())
        self.checked = traffic_mod.sample_points(self.seed, inp, int(self.cell.checks["points"]))
        _sync(dev)
        self.marks["inputs"] = time.perf_counter()
        # warm-up: every job queued at once, a few rounds and the summary
        state, point_tasks, _ = self.sweep.grid_state(
            inp.scheduler, self.scfg, self.tasks, torch.zeros_like(inp.submit),
            torch.zeros_like(inp.job_submit), inp.seeds, WARM_ROUNDS,
            match_fn=self.probe if self.trace else self.match_fn, draws=inp.draws)
        self.sweep.point_summary(state, point_tasks)
        del state, point_tasks
        _sync(dev)
        self.marks["warm"] = time.perf_counter()

    # -- the window -----------------------------------------------------------

    def _grid(self):
        """One grid as ``sweep_grid`` runs it; returns (final state, the
        summary on the host, one value per point)."""
        inp = self.inputs
        state, point_tasks, step = self.sweep.grid_state(
            inp.scheduler, self.scfg, self.tasks, inp.submit, inp.job_submit, inp.seeds,
            inp.num_rounds, match_fn=self.match_fn, draws=inp.draws)
        summary = self.sweep.point_summary(state, point_tasks)
        host = {k: v.cpu().numpy() for k, v in summary.items()}
        _sync(self.device)
        self.borrow_rounds.append(getattr(step, "borrow_rounds", 0))
        return state, host

    def _traced_grid(self, first: bool):
        """One grid run stage by stage, each stage timed (a sync at each
        boundary); in the ``first`` grid, a stretch of rounds is run twice
        from one state: under the profiler, then counting host syncs and the
        lanes each match launch needs.  Its rounds are left out of the
        stages' walls."""
        inp, dev, sw, rt = self.inputs, self.device, self.sweep, self.runtime
        R = inp.num_rounds
        t0 = time.perf_counter()
        step, state, point_tasks = sw.build_grid(
            inp.scheduler, self.scfg, self.tasks, inp.submit, inp.job_submit, inp.seeds,
            match_fn=self.probe, draws=inp.draws)
        _sync(dev)
        t1 = time.perf_counter()
        scan_s = 0.0
        if first:
            k0 = min(TRACE_START, R // 4)
            m = max(1, min(TRACE_ROUNDS, R // 4))
            state = rt.scan_rounds(step, state, k0)
            _sync(dev)
            t2 = time.perf_counter()
            self.tr["stretch_rounds"] = m
            state = self._profile(step, state, m)
            scan_s += t2 - t1
            t4 = time.perf_counter()
            state = rt.scan_rounds(step, state, R - k0 - m)
            _sync(dev)
            t5 = time.perf_counter()
            scan_s += t5 - t4
            rounds = R - m
        else:
            state = rt.scan_rounds(step, state, R)
            _sync(dev)
            t5 = time.perf_counter()
            scan_s = t5 - t1
            rounds = R
        summary = sw.point_summary(state, point_tasks)
        host = {k: v.cpu().numpy() for k, v in summary.items()}
        _sync(dev)
        t6 = time.perf_counter()
        # the replayed stretch's borrow rounds are not the grid's
        self.borrow_rounds.append(getattr(step, "borrow_rounds", 0) - self.tr.pop("replayed", 0))
        self.tr["grid_prep_s"].append((t1 - t0) + (t6 - t5))
        self.tr["scan_s"].append(scan_s)
        self.tr["scan_rounds"].append(rounds)
        return state, host

    def _profile(self, step, state, m: int):
        """``m`` rounds from ``state`` under the profiler, then again from
        the same state; returns the profiled run's state."""
        from torch.profiler import ProfilerActivity, profile

        rt, dev = self.runtime, self.device
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.probe.mode = "shapes"
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            profiled = rt.scan_rounds(step, state, m)
            _sync(dev)
            p1 = time.perf_counter()
        shapes, _ = self.probe.take()
        before = getattr(step, "borrow_rounds", 0)
        self.probe.mode = "lanes"
        with devtrace.count_syncs() as syncs:
            out = rt.scan_rounds(step, state, m)
        _sync(dev)
        del out
        rshapes, lanes = self.probe.take()
        self.probe.mode = "off"
        dev_ev, host_ev = devtrace.events(prof)
        self.tr.update(
            replayed=getattr(step, "borrow_rounds", 0) - before,
            window_s=p1 - p0, device=dev_ev, host=host_ev, busy_s=devtrace.busy_seconds(dev_ev),
            host_syncs=syncs[0],
            match_launches=[dict(rows=r, width=w, elem=e, lanes=n)
                            for (r, w, e), n in zip(shapes, lanes)]
            if shapes == rshapes else None)
        return profiled

    def window(self) -> None:
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.tr = dict(grid_prep_s=[], scan_s=[], scan_rounds=[])
        self.grids, self.walls, self.borrow_rounds = [], [], []
        checked = torch.tensor(self.checked, device=dev)
        w0 = time.perf_counter()
        while True:
            g0 = time.perf_counter()
            state, host = (self._traced_grid(not self.grids) if self.trace else self._grid())
            self.walls.append(time.perf_counter() - g0)
            self.grids.append(host)
            self.port_finish = state.task_finish[checked].cpu().numpy()
            del state
            if time.perf_counter() - w0 + self.walls[0] > self.seconds:
                break
        self.window_s = time.perf_counter() - w0
        self.peak_bytes = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
        self.forbidden_after_window = forbidden_modules()

    # -- the comparison -------------------------------------------------------

    def reference_inputs(self) -> dict:
        inp = self.inputs
        loads = torch.tensor([inp.point(b)[0] for b in self.checked], device=self.device)
        seeds = torch.tensor([inp.point(b)[1] for b in self.checked], device=self.device)
        return dict(job=inp.job, duration=inp.duration, job_ntasks=inp.job_ntasks,
                    submit=inp.submit[loads], job_submit=inp.job_submit[loads],
                    **{name: draw[seeds] for name, draw in inp.draws.items()})

    def reference(self, time_dtype=torch.float32) -> tuple[np.ndarray, dict]:
        """The plain reference at the checked points: finish times [K, T] and
        its own summary columns."""
        inp = self.inputs
        ref = self.cell.reference().simulate(
            self.cell.cfg, self.reference_inputs(), inp.num_rounds, time_dtype=time_dtype)
        finish = ref["task_finish"].float().cpu().numpy()
        summary = judge.summarize(
            finish, ref["t"].float().cpu().numpy(),
            {k: v.cpu().numpy() for k, v in ref.items() if k not in ("task_finish", "t")},
            inp.job.cpu().numpy(), inp.duration.cpu().numpy(),
            inp.job_submit[[inp.point(b)[0] for b in self.checked]].cpu().numpy(),
            self.cell.cfg["num_workers"])
        return finish, summary

    def compare(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        r0 = time.perf_counter()
        ref_finish, ref_summary = self.reference()
        self.reference_s = time.perf_counter() - r0
        self.values = judge.numbers(self.grids, self.checked, self.port_finish, ref_finish,
                                    ref_summary, self.inputs.num_tasks)
        self.correct, self.check_lines = judge.verdict(self.values, self.cell.checks["limits"])
        self.failed = judge.failed_points(self.grids, self.inputs.num_tasks, self.checked,
                                          self.port_finish, ref_finish)

    # -- the result -----------------------------------------------------------

    def context(self) -> dict:
        """What the metric readers read."""
        ctx = dict(
            setup_s=self.marks["warm"] - self.marks["start"],
            grid_walls=self.walls,
            grid_tasks=[int(g["tasks_done"].astype(np.int64).sum()) for g in self.grids],
            peak_bytes=self.peak_bytes,
            on_card=self.device.type == "cuda",
            peaks=traffic_mod.load_json(self.cell.bench_dir / "peaks.json"),
        )
        ctx.update(self.tr)
        return ctx

    def result(self) -> dict:
        ctx = self.context()
        metrics = {}
        for m in (self.cell.per_layer if self.trace else self.cell.end_to_end):
            value = self.cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = self.device
        device = {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(self.peak_bytes),
        }
        out = {"correct": bool(self.correct),
               "attempted": len(self.grids) * self.inputs.num_points,
               "failed": int(self.failed), "metrics": metrics, "device": device}
        if self.trace and "busy_s" in self.tr:
            device["busy_s"] = self.tr["busy_s"]
            device["window_s"] = self.tr["window_s"]
            out["breakdown"] = {
                "device_ops": devtrace.top_ops(self.tr["device"]),
                "idle_gaps": devtrace.idle_gaps(self.tr["device"], self.tr["host"]),
            }
        out["checks"] = {k: {"value": self.values[k], "limit": self.cell.checks["limits"][k]}
                         for k in judge.NUMBERS}
        return out

    def setup_lines(self) -> list[str]:
        """The lines printed before the result: ``setup_s`` by stage, the
        window's grids, the reference's time and the card."""
        order = ("start", "imports", "cuda_init", "kernel_load", "inputs", "warm")
        m = self.marks
        parts = [f"{b} {m[b] - m[a]:.3f} s" for a, b in zip(order, order[1:])]
        return [f"setup_s {m['warm'] - m['start']:.3f}: " + ", ".join(parts),
                f"window {self.window_s:.3f} s, grids {len(self.grids)}, walls "
                + " ".join(f"{w:.3f}" for w in self.walls)
                + f", rounds {self.inputs.num_rounds} (borrow {self.borrow_rounds}), points "
                + f"{self.inputs.num_points}",
                f"reference {self.reference_s:.3f} s on points {self.checked}",
                f"card {card_info() if self.device.type == 'cuda' else {}}; peaks "
                + json.dumps(traffic_mod.load_json(self.cell.bench_dir / "peaks.json"))]


def card_info() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out.splitlines()[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, marks: dict):
    """Run one cell; returns ``(exit code, result or None, lines for stdout,
    lines for stderr)``."""
    run = Run(cell, seed, seconds, trace, device, marks)
    run.setup()
    run.window()
    run.compare()
    result = run.result()
    found = sorted(set(run.forbidden_after_window) | set(forbidden_modules()))
    if found:
        return 3, None, [], [f"forbidden modules loaded: {found}"]
    return 0, result, run.setup_lines(), run.check_lines


def dumps(result: dict) -> str:
    return json.dumps(result, separators=(",", ":"))
