"""A new trace shape and a new rule join the benchmark as files alone.

Each test copies the benchmark into a fresh tree, adds files and manifest
entries there and nothing else, and runs the copy's harness in a process of
its own on the CPU: a trace generator under ``generators/`` that makes jobs
of two sizes and two task lengths, run by every configuration of the
manifest against the references as they are; and a rule's draws under ``draws/``
(Pigeon, which draws nothing, its reference taken out of the copy), which
get through set-up and the window, while the comparison names the reference
file still missing."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import traffic
from portbench.cpu_cells import ROOT, TINY

TWO_SIZES = '''
"""Jobs of two sizes and two task lengths: every third job has ``large``
tasks and the rest ``small``, every other job's tasks last ``long_s`` and
the rest ``short_s``; Poisson arrivals at each load's mean gap."""

import random

import numpy as np


def trace(cfg, traffic, seed):
    J = int(traffic["num_jobs"])
    j = np.arange(J)
    ntasks = np.where(j % 3 == 0, traffic["large"], traffic["small"]).astype(np.int32)
    length = np.where(j % 2 == 0, traffic["long_s"], traffic["short_s"]).astype(np.float32)
    job = np.repeat(j.astype(np.int32), ntasks)
    rng = random.Random(seed)
    unit = np.cumsum([0.0] + [rng.expovariate(1.0) for _ in range(J - 1)])
    work = float((ntasks * length).mean())
    return dict(job=job, duration=length[job], job_ntasks=ntasks,
                job_submit=np.stack([(unit * work / (load * cfg["num_workers"]))
                                     .astype(np.float32) for load in traffic["loads"]]))
'''

NO_DRAWS = '''
"""Pigeon draws nothing: its groups and queues follow from the configuration."""


def make(cfg, trace, seed, device):
    return {}
'''


def _copy(tmp_path):
    """A copy of the benchmark: ``BENCHMARK.json`` and ``portbench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench"


def _add_cell(root, name, config, traffic_name, traffic_json, config_file=None):
    """Files and manifest entries of one cell in the copy at ``root``."""
    bench = root / "portbench"
    (bench / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic_json))
    checks = json.loads((bench / "checks" / "megha_synth_50k.fig2_l16s4.json").read_text())
    (bench / "checks" / f"{name}.json").write_text(json.dumps(dict(checks, points=2)))
    m = json.loads((root / "BENCHMARK.json").read_text())
    if config_file is not None:
        (bench / "configs" / f"{config}.json").write_text(json.dumps(config_file))
        m["configs"].append(dict(m["configs"][0], name=config,
                                 file=f"portbench/configs/{config}.json"))
    m["workloads"].append(dict(m["workloads"][0], name=name, config=config,
                               traffic=traffic_name))
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def _in_copy(root, body: str) -> dict:
    """Run ``body`` in a fresh process that imports the copy's benchmark;
    the JSON object it prints last."""
    script = textwrap.dedent("""
        import json, sys, time
        sys.path[:0] = [{root!r}, {src!r}]
        import torch
        torch.set_num_threads(1)
        from pathlib import Path
        from portbench import harness
        from portbench.cpu_cells import run_tiny
        ROOT = Path({root!r})
    """).format(root=str(root), src=str(ROOT / "src")) + textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


CONFIGS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]]


@pytest.mark.parametrize("config", CONFIGS)
def test_a_new_trace_generator_needs_files_only(config, tmp_path):
    bench = _copy(tmp_path)
    (bench / "generators" / "two_sizes.py").write_text(TWO_SIZES)
    mix = dict(generator="two_sizes", about="two job sizes, two task lengths",
               loads=[0.6, 0.95], scheduler_seeds=2, num_jobs=12, small=48, large=160,
               short_s=0.5, long_s=2.0, slack=4.0)
    _add_cell(tmp_path, f"{config}.two_sizes", config, "two_sizes", mix)
    out = _in_copy(tmp_path, f"""
        cell = harness.resolve(ROOT, "{config}.two_sizes")
        cell.cfg["num_workers"] = 640
        run = run_tiny(cell)
        inp = run.inputs
        print(json.dumps(dict(
            correct=run.correct, failed=run.failed, values=run.values,
            sizes=sorted(set(inp.job_ntasks.tolist())),
            lengths=sorted(set(inp.duration.tolist())),
            tasks_done=[int(g["tasks_done"].sum()) for g in run.grids],
            tasks=inp.num_tasks * inp.num_points)))
    """)
    assert out["sizes"] == [48, 160] and out["lengths"] == [0.5, 2.0]
    assert out["correct"] and out["failed"] == 0, out["values"]
    assert out["values"]["finish_gap_s"] == 0.0 and out["values"]["count_gap"] == 0.0
    assert out["tasks_done"] == [out["tasks"]]


def test_a_new_rule_needs_files_only(tmp_path):
    bench = _copy(tmp_path)
    (bench / "draws" / "pigeon.py").write_text(NO_DRAWS)
    (bench / "references" / "pigeon.py").unlink(missing_ok=True)
    cfg = json.loads((bench / "configs" / "megha_synth_50k.json").read_text())
    cfg.update(scheduler="pigeon", num_workers=640, group_size=40, num_distributors=5,
               reserved_per_group=2, wfq_weight=4)
    mix = json.loads((bench / "traffic" / "fig2_l8s6.json").read_text())
    _add_cell(tmp_path, "pigeon_tiny.tiny_mix", "pigeon_tiny", "tiny_mix",
              dict(mix, **TINY), config_file=cfg)
    out = _in_copy(tmp_path, """
        cell = harness.resolve(ROOT, "pigeon_tiny.tiny_mix")
        t = time.perf_counter()
        run = harness.Run(cell, 2**31 + 11, 0.0, False, "cpu",
                          {"start": t, "imports": t, "cuda_init": t})
        run.setup()
        run.window()
        try:
            run.compare()
            error = None
        except FileNotFoundError as e:
            error = str(e)
        print(json.dumps(dict(
            draws=sorted(run.inputs.draws), error=error,
            tasks_done=[int(g["tasks_done"].sum()) for g in run.grids],
            tasks=run.inputs.num_tasks * run.inputs.num_points)))
    """)
    assert out["draws"] == [] and out["tasks_done"] == [out["tasks"]]
    assert out["error"] is not None and "references/pigeon.py" in out["error"]


@pytest.mark.parametrize("kind, cfg, mix", [
    ("draws", {"scheduler": "no_such_rule"}, {"generator": "synthetic_fig2"}),
    ("generators", {"scheduler": "megha"}, {"generator": "no_such_trace"}),
])
def test_a_missing_file_is_named(kind, cfg, mix):
    name = cfg["scheduler"] if kind == "draws" else mix["generator"]
    with pytest.raises(FileNotFoundError, match=f"portbench/{kind}/{name}.py"):
        traffic.build(cfg, mix, 1, torch.device("cpu"))
