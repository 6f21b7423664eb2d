"""The manifest, the files it names, and finding a new cell with no edit."""

import json
import re
import shutil

import pytest

from portbench.cpu_cells import ROOT, run_tiny, shrink, tiny
from portbench import harness, judge, traffic
from repro_torch.simx import runtime

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_follows_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][1] == "portbench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["layer"] and "bound" not in x
    for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]), x["name"]
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}


CELL_NAMES = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_every_cell_resolves_its_files(cell):
    c = harness.resolve(ROOT, cell)
    assert c.traffic["loads"] and c.checks["points"] >= 1
    assert set(c.checks["limits"]) == set(judge.NUMBERS)
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "sim_tasks_per_s"}
    # the per-layer entries the manifest lists for the cell, in its order
    listed = [x["name"] for x in manifest()["per_layer"] if cell in x.get("workloads", [cell])]
    assert [m["name"] for m in c.per_layer] == listed


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_every_cell_meets_the_rule_contract(cell):
    """The scheduler is a rule the port registers; at the tiny size its
    draws file gives exactly the rule's draws, each with the seed axis; its
    reference simulates.  (Each per-layer entry's reader is loaded by
    ``test_every_cell_resolves_its_files``.)"""
    c = shrink(harness.resolve(ROOT, cell))
    rule = runtime.get_rule(c.cfg["scheduler"])
    inp = traffic.build(c.cfg, c.traffic, 2**31 + 9, "cpu")
    assert set(inp.draws) == set(rule.draw_dims)
    for name, dims in rule.draw_dims.items():
        assert inp.draws[name].dim() == dims + 1
        assert inp.draws[name].shape[0] == len(inp.seeds)
    assert callable(c.reference().simulate)


def test_a_new_cell_is_found_by_name_in_a_copy(tmp_path):
    """Files added under configs/, traffic/ and checks/ and entries added to
    the manifest are all a new cell needs."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "megha_synth_50k.json").read_text())
    cfg.update(num_workers=640)
    (bench / "configs" / "megha_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "fig2_l8s6.json").read_text())
    traffic.update(loads=[0.5, 0.9], scheduler_seeds=2, num_jobs=12, tasks_per_job=96)
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    checks = json.loads((bench / "checks" / "megha_synth_50k.fig2_l16s4.json").read_text())
    checks["points"] = 2
    (bench / "checks" / "megha_tiny.tiny_mix.json").write_text(json.dumps(checks))
    m = manifest()
    m["configs"].append(dict(m["configs"][0], name="megha_tiny",
                             file="portbench/configs/megha_tiny.json"))
    m["workloads"].append(dict(m["workloads"][0], name="megha_tiny.tiny_mix",
                               config="megha_tiny", traffic="tiny_mix"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve(tmp_path, "megha_tiny.tiny_mix")
    assert cell.cfg["num_workers"] == 640 and cell.traffic["loads"] == [0.5, 0.9]
    assert cell.bench_dir == bench
    run = run_tiny(cell)
    assert run.correct and run.inputs.num_points == 4


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    run = run_tiny(tiny("megha"), trace=trace)
    out = run.result()
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 4
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(judge.NUMBERS)
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    names = {m["name"] for m in (run.cell.per_layer if trace else run.cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:
        # on the CPU only the host-clock numbers have something to read
        assert set(out["metrics"]) == {"sim_tasks_per_s", "setup_s"}
    json.loads(harness.dumps(out))
