"""The port's static contract analysis (``repro_torch.analysis``), its trace
files and its quickstart, against the reference on the CPU.

Specs: the grammar, every state dataclass's spec strings and
``check_state``'s verdicts equal the reference's (``repro.analysis``) on
the same seeded drift; the port's leading point and lane axes are
stripped.  The stage table equals the reference's.  The linter's codes
fire on ``tests/fixtures/torch_simxlint_violations.py`` at the marked
lines, its twins stay silent, and ``src/repro_torch/simx`` lints clean
with exactly the one deliberate host read suppressed.  ``speccheck``
passes on the CPU; the sync counter counts 0 there and restores torch's
mode.  Trace files cross between the packages; the quickstart's numbers
equal the reference's functions at the same size."""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import simxlint as jax_simxlint
from repro.analysis import speccheck as jax_speccheck
from repro.analysis import specs as jax_specs
from repro.core import fastpath as jax_fp
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.simx import engine as jax_engine  # noqa: F401 (registers the rules)
from repro.simx import megha as jax_megha
from repro.simx import runtime as jax_rt
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import sweep as jax_sweep
from repro.simx.state import SimxConfig as JaxSimxConfig
from repro.simx.state import export_workload as jax_export_workload
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.analysis import sentinels, simxlint, speccheck, specs
from repro_torch.analysis.specs import SpecError, check_state, dims_for, parse_spec
from repro_torch.simx import runtime as rt
from repro_torch.simx import shard, stream
from repro_torch.simx.state import SimxConfig, export_workload
from repro_torch.workload import synth, traces

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_simxlint_violations.py"
PORT_SIMX = ROOT / "src" / "repro_torch" / "simx"
RULES = ("megha", "sparrow", "eagle", "pigeon", "oracle")
SMALL_CFG = dict(num_workers=32, num_gms=2, num_lms=2, group_size=16)
SMALL_TRACE = dict(num_jobs=8, tasks_per_job=3, load=0.5, num_workers=32, seed=0)


@pytest.fixture(scope="module")
def small():
    """speccheck's tiny instance in both packages: (cfg, tasks) each."""
    wl = synth.synthetic_trace(**SMALL_TRACE)
    jwl = jax_synth.synthetic_trace(**SMALL_TRACE)
    return (SimxConfig(**SMALL_CFG), export_workload(wl, "cpu"),
            JaxSimxConfig(**SMALL_CFG), jax_export_workload(jwl))


def _labels(err: Exception) -> set:
    """The ``where.field`` labels of a ``SpecError``'s violation lines."""
    return {m.group(1) for m in re.finditer(r"^\s+(\S+?): ", str(err), re.M)}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

GRAMMAR = ["int32[W, R]", "float32[]", "bool[G, W]", "int32[NG, ?]", "float32[Q, 5]",
           " uint8 [ T ] "]
MALFORMED = ["int32", "int32[", "[W]", "int32[W,, R]", "int 32[W]", "", "int32[W-1]"]


@pytest.mark.parametrize("text", GRAMMAR)
def test_parse_spec_equals_the_reference(text):
    ours, theirs = parse_spec(text), jax_specs.parse_spec(text)
    assert (ours.dtype, ours.dims, ours.text) == (theirs.dtype, theirs.dims, theirs.text)


@pytest.mark.parametrize("bad", MALFORMED)
def test_parse_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(jax_specs.SpecError):
        jax_specs.parse_spec(bad)
    with pytest.raises(SpecError):
        parse_spec(bad)


_PAIRS = list(zip(speccheck._known_pytrees(), jax_speccheck._known_pytrees()))


@pytest.mark.parametrize("ours,theirs", _PAIRS, ids=[p[0].__name__ for p in _PAIRS])
def test_field_specs_equal_the_reference(ours, theirs):
    """Every state dataclass carries the reference's spec strings, field
    for field, and no tensor field lacks one.  ``GridShard`` carries each
    point's draws (a dict, no spec) where the reference carries a PRNG
    seed: the port's rules take their draws as an argument."""
    assert ours.__name__ == theirs.__name__
    mine = {k: v.text for k, v in specs.field_specs(ours).items()}
    want = {k: v.text for k, v in jax_specs.field_specs(theirs).items()}
    if ours.__name__ == "GridShard":
        assert want.pop("seed") == "int32[B]"
        assert [f.name for f in dataclasses.fields(ours)][-1] == "draws"
    assert list(mine.items()) == list(want.items())
    assert specs.missing_specs(ours) == [] and jax_specs.missing_specs(theirs) == []


def test_missing_specs_flags_an_unannotated_tensor():
    @dataclasses.dataclass
    class Gappy:
        a: torch.Tensor = dataclasses.field(default=None, metadata={"spec": "int32[W]"})
        b: "torch.Tensor" = None  # a tensor field without a spec
        c: int = 0                # not a tensor

    assert specs.missing_specs(Gappy) == ["b"]


def test_dtype_names_cover_the_grammar():
    for dtype, name in specs.DTYPE_NAMES.items():
        assert specs.dtype_name(dtype) == name == str(dtype).removeprefix("torch.")
    with pytest.raises(SpecError):
        specs.dtype_name(torch.complex64)


@pytest.mark.parametrize("name", RULES)
def test_check_state_accepts_single_and_batched_states(small, name):
    cfg, tasks, *_ = small
    dims = dims_for(cfg, tasks)
    rule = rt.get_rule(name)
    check_state(tasks, dict(dims), where="TaskArrays")
    check_state(rule.init(cfg, tasks), dict(dims), where=name)
    got = check_state(rule.init(cfg, tasks, 4), dict(dims), where=name, lead=("B",))
    assert got["B"] == 4
    # the point axis must be named: without it every field is one rank off
    with pytest.raises(SpecError):
        check_state(rule.init(cfg, tasks, 4), dict(dims))


@pytest.fixture(scope="module")
def lane_curve():
    """One segment of a 2-lane megha curve on a 4 x 4 grid: the lane count
    is not ``num_lms``."""
    loop = stream._SteadyLoop(
        "megha", [synth.PoissonArrivals(rate=r, seed=0) for r in (10.0, 20.0)], 64,
        devices=shard.Mesh(("cpu",)), entry="sharded_steady_state", window_jobs=16,
        window_tasks=64, rounds_per_refill=8, num_gms=4, num_lms=4)
    seg = loop.segment()
    return loop, seg


def test_check_state_strips_the_lane_axis(lane_curve):
    loop, seg = lane_curve
    win = loop.wins[0]
    dims = dict(W=loop.cfg.num_workers, G=4, L=4, NG=loop.cfg.num_groups,
                T=win.T_cap, J=win.J_cap)
    lanes = ("lanes",)
    got = check_state(seg["state"], dict(dims), lead=lanes, where="state")
    assert got["lanes"] == 2 and got["L"] == 4
    check_state(stream._stack_tasks(loop.wins, torch.device("cpu")), dict(dims), lead=lanes)
    check_state(rt.tree_join(torch.stack, [w.layout() for w in loop.wins]), dict(dims),
                lead=lanes)
    check_state(seg["sketch"], {}, lead=lanes)
    # binding the lane axis to the spec symbol L (num_lms) would be wrong
    with pytest.raises(SpecError, match=r"dim L=2 conflicts with L=4"):
        check_state(seg["state"], dict(dims), lead=("L",))


def _both_errors(small, drift, jax_drift=None) -> tuple:
    """The violation labels of the same drift of a fresh megha state in
    each package (``jax_drift`` where the two need different calls)."""
    cfg, tasks, jcfg, jtasks = small
    ours = rt.get_rule("megha").init(cfg, tasks)
    theirs = jax_rt.get_rule("megha").init(jcfg, jtasks)
    with pytest.raises(SpecError) as a:
        check_state(dataclasses.replace(ours, **drift(ours)), dims_for(cfg, tasks),
                    where="MeghaState")
    with pytest.raises(jax_specs.SpecError) as b:
        jax_specs.check_state(dataclasses.replace(theirs, **(jax_drift or drift)(theirs)),
                              jax_specs.dims_for(jcfg, jtasks), where="MeghaState")
    return _labels(a.value), _labels(b.value)


def test_check_state_reports_the_reference_fields_on_dtype_drift(small):
    ours, theirs = _both_errors(
        small, lambda s: dict(rnd=s.rnd.to(torch.float32), lost=s.lost.to(torch.float32)),
        lambda s: dict(rnd=s.rnd.astype(jnp.float32), lost=s.lost.astype(jnp.float32)))
    assert ours == theirs == {"MeghaState.rnd", "MeghaState.lost"}


def test_check_state_reports_the_reference_fields_on_shape_drift(small):
    ours, theirs = _both_errors(
        small, lambda s: dict(worker_finish=s.worker_finish[:-1], head=s.head[:1]))
    assert ours == theirs == {"MeghaState.worker_finish", "MeghaState.head"}


def test_check_state_catches_promotion_as_dtype_drift(small):
    """The reference's weak-type test in torch: ``x + 1.0`` on the int32
    round counter gives a plain float32 tensor, and the dtype check (no
    weak-type check exists or is needed) reports it."""
    cfg, tasks, *_ = small
    state = rt.get_rule("megha").init(cfg, tasks)
    bad = dataclasses.replace(state, rnd=state.rnd + 1.0)
    assert bad.rnd.dtype == torch.float32
    with pytest.raises(SpecError, match=r"MeghaState\.rnd: dtype float32, spec says int32\[\]"):
        check_state(bad, dims_for(cfg, tasks), where="MeghaState")


def test_check_state_reports_every_violation_at_once(small):
    cfg, tasks, *_ = small
    state = rt.get_rule("megha").init(cfg, tasks)
    bad = dataclasses.replace(state, rnd=state.rnd.float(), lost=state.lost.float(),
                              view=state.view[:, :-1])
    with pytest.raises(SpecError) as e:
        check_state(bad, dims_for(cfg, tasks))
    assert str(e.value).startswith("3 spec violation(s)")
    assert _labels(e.value) == {"MeghaState.rnd", "MeghaState.lost", "MeghaState.view"}


def test_check_state_recurses_into_nested_layouts():
    cfg = stream.stream_config("eagle", 32, window_tasks=64, num_gms=2, num_lms=2)
    win = stream._StreamWindow(synth.PoissonArrivals(rate=20.0, seed=0), cfg, "eagle", 16,
                               64, 0, torch.device("cpu"))
    layout = win.layout()
    check_state(layout, {"J": win.J_cap})
    probes = dataclasses.replace(layout.probes, edge_end=layout.probes.edge_end[:-1])
    with pytest.raises(SpecError, match=r"EagleLayout\.probes\.edge_end"):
        check_state(dataclasses.replace(layout, probes=probes), {"J": win.J_cap})


# ---------------------------------------------------------------------------
# the stage table
# ---------------------------------------------------------------------------


def test_stage_table_equals_the_reference():
    assert rt.RUNTIME_OWNED_FIELDS == jax_rt.RUNTIME_OWNED_FIELDS
    assert rt.STAGE_TABLE == jax_rt.STAGE_TABLE
    assert [s[0] for s in rt.STAGE_TABLE] == [
        "faults", "complete", "dispatch", "telemetry", "metrics"]
    assert dict((s[0], s[1]) for s in rt.STAGE_TABLE)["dispatch"] == "rule"


def test_sc101_reads_the_ports_runtime(tmp_path, monkeypatch):
    """SC101's owned fields come from ``repro_torch.simx.runtime``: a field
    added there is enforced at once."""
    assert simxlint._runtime_owned_fields() == rt.RUNTIME_OWNED_FIELDS
    f = tmp_path / "rule.py"
    f.write_text("def make_x_step(cfg):\n"
                 "    def dispatch(s, t, a, b, free, comp, lost_w):\n"
                 "        return dict(messages=s.messages)\n"
                 "    return dispatch\n")
    assert simxlint.lint_paths([f]) == []
    monkeypatch.setattr(rt, "RUNTIME_OWNED_FIELDS", rt.RUNTIME_OWNED_FIELDS + ("messages",))
    assert [(x.code, x.line) for x in simxlint.lint_paths([f])] == [("SC101", 3)]


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

#: every finding the fixture must produce, as (code, line): the comments in
#: the fixture mark each seeded violation
EXPECTED = [
    ("TH001", 20), ("TH001", 22),
    ("TH001", 37), ("TH001", 38), ("TH001", 39), ("TH001", 40), ("TH001", 41), ("TH001", 42),
    ("TH001", 64), ("TH001", 68),
    ("SC101", 77), ("SC101", 81),
    ("SC102", 110),
]


def test_lint_fixture_fires_every_rule():
    got = [(f.code, f.line) for f in simxlint.lint_paths([FIXTURE])]
    assert got == EXPECTED
    assert {c for c, _ in got} == {"TH001", "SC101", "SC102"}
    # each marked line is a finding, and each finding a marked line
    src = FIXTURE.read_text().splitlines()
    marked = [(m.group(1), i + 1) for i, line in enumerate(src)
              for m in [re.search(r"# (TH001|SC101|SC102) ", line)] if m]
    assert sorted(marked, key=lambda x: x[1]) == EXPECTED


@pytest.mark.parametrize("kind", [str, Path], ids=["str", "Path"])
def test_lint_file_is_lint_paths_of_that_file(kind):
    """``lint_file(path)`` (the reference's one-file entry point) finds what
    ``lint_paths([path])`` finds, as the same ``Finding`` records."""
    got = simxlint.lint_file(kind(FIXTURE))
    assert got == simxlint.lint_paths([kind(FIXTURE)])
    assert [(f.code, f.line) for f in got] == EXPECTED
    assert all(type(f) is simxlint.Finding for f in got)


@pytest.mark.parametrize("module", sorted(p.relative_to(ROOT / "src").as_posix()
                                          for p in (ROOT / "src" / "repro_torch").rglob("*.py")))
def test_lint_file_on_every_port_module(module):
    path = ROOT / "src" / module
    assert simxlint.lint_file(path) == simxlint.lint_paths([path])


def test_lint_file_missing_path_raises_as_the_reference(tmp_path):
    missing = tmp_path / "nope.py"
    with pytest.raises(FileNotFoundError):
        jax_simxlint.lint_file(missing)
    with pytest.raises(FileNotFoundError):
        simxlint.lint_file(missing)
    with pytest.raises(FileNotFoundError):
        simxlint.lint_file(str(missing))


def test_lint_fixture_suppressed_and_clean_twins_stay_silent():
    findings = simxlint.lint_paths([FIXTURE])
    src = FIXTURE.read_text().splitlines()
    flagged = {f.line for f in findings}
    silent = {i + 1 for i, line in enumerate(src)
              if "simxlint: disable=" in line or "# silent" in line}
    assert len(silent) >= 6, "fixture lost its suppressed/clean twins"
    assert not flagged & silent


def test_lint_file_level_disable(tmp_path):
    body = ("import torch\n"
            "def dispatch(s, t, a, b, free, comp, lost_w):\n"
            "    return float(t)\n")
    f = tmp_path / "mod.py"
    f.write_text("# simxlint: disable-file=TH001\n" + body)
    assert simxlint.lint_paths([f]) == []
    g = tmp_path / "mod2.py"
    g.write_text(body)
    assert [(x.code, x.line) for x in simxlint.lint_paths([g])] == [("TH001", 3)]


def test_lint_follows_step_calls_across_files(tmp_path):
    """A step-scope call through an import alias reaches the other file's
    function (``rt.take`` in the port); a step factory's body stays host
    code even where a step calls the factory."""
    pkg = tmp_path / "repro_torch" / "fake"
    pkg.mkdir(parents=True)
    (pkg / "helpers.py").write_text(
        "def pull(x):\n"
        "    return x.cpu()\n"
        "def make_inner_step(cfg):\n"
        "    if cfg.any():\n"
        "        return None\n"
        "    return None\n"
        "def unused(x):\n"
        "    return x.item()\n")
    (pkg / "rule.py").write_text(
        "from repro_torch.fake import helpers as hp\n"
        "def dispatch(s, t, a, b, free, comp, lost_w):\n"
        "    hp.make_inner_step(s)\n"
        "    return dict(task_finish=hp.pull(a))\n")
    got = [(Path(x.file).name, x.line, x.code) for x in simxlint.lint_paths([tmp_path])]
    assert got == [("helpers.py", 2, "TH001")]


def test_lint_syntax_error_is_a_finding_not_a_crash(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def oops(:\n")
    assert [x.code for x in simxlint.lint_paths([f])] == ["E000"]


def test_lint_finding_format_is_file_line_code():
    f = simxlint.lint_paths([FIXTURE])[0]
    assert str(f) == f"{f.file}:{f.line}: {f.code} {f.message}"
    assert str(f).startswith(f"{FIXTURE}:20: TH001 ")


def test_lint_cli_exit_codes(tmp_path, capsys):
    assert simxlint.main([str(PORT_SIMX)]) == 0
    assert simxlint.main([str(FIXTURE)]) == 1
    assert f"{FIXTURE}:20: TH001" in capsys.readouterr().out
    assert simxlint.main([]) == 2
    assert simxlint.main([str(tmp_path / "nope.txt")]) == 2
    assert simxlint.main([str(FIXTURE), "--report"]) == 2


def test_lint_cli_report_artifact(tmp_path):
    rpt = tmp_path / "lint.json"
    assert simxlint.main([str(FIXTURE), "--report", str(rpt)]) == 1
    data = json.loads(rpt.read_text())
    assert [(d["code"], d["line"]) for d in data] == EXPECTED
    assert set(data[0]) == {"file", "line", "code", "message"}


def test_port_simx_lints_clean_with_one_deliberate_read():
    """``src/repro_torch/simx`` has no host read in a step but megha's
    borrow check (the reference's ``lax.cond``), which is suppressed with
    its reason; step factory bodies (the fixed-trace layouts megha, pigeon
    and eagle build when no layout is given) stay host code."""
    assert simxlint.lint_paths([PORT_SIMX]) == []
    sup = [(f.name, i, m.group(1).strip())
           for f in sorted(PORT_SIMX.rglob("*.py"))
           for i, line in enumerate(f.read_text().splitlines(), 1)
           for m in [re.search(r"#\s*simxlint:\s*disable(?:-file)?=([A-Z0-9, ]+)", line)] if m]
    assert sup == [("megha.py", 374, "TH001")]
    line = (PORT_SIMX / "megha.py").read_text().splitlines()[373]
    assert "bool(torch.any(need_b))" in line and "lax.cond" in line


def test_reference_linter_still_passes_the_reference():
    """The port's linter sits beside the reference's, which still lints
    ``src/repro/simx`` clean."""
    assert jax_simxlint.lint_paths([ROOT / "src" / "repro" / "simx"]) == []


# ---------------------------------------------------------------------------
# speccheck and the sync counter
# ---------------------------------------------------------------------------


def test_speccheck_passes_on_the_cpu(tmp_path):
    rpt = tmp_path / "spec.json"
    assert speccheck.main(["--device", "cpu", "--report", str(rpt)]) == 0
    results = json.loads(rpt.read_text())
    assert [r["check"] for r in results] == [
        "coverage", "constructors", "step-stability", "stage-helpers", "stream-layouts",
        "stream-lanes", "sharded-drivers"]
    assert all(r["ok"] for r in results)
    assert speccheck.main(["--device"]) == 2


def test_speccheck_reports_a_failing_check(monkeypatch):
    """A drifted constructor fails its check and only it."""
    rule = rt.get_rule("oracle")
    bad_init = lambda cfg, tasks, batch=None: dataclasses.replace(  # noqa: E731
        rule.init(cfg, tasks, batch), head=rule.init(cfg, tasks, batch).head.float())
    monkeypatch.setitem(rt.RULES, "oracle", dataclasses.replace(rule, init=bad_init))
    rep = speccheck.Report()
    rep.run("constructors", lambda: speccheck.check_constructors("cpu"))
    rep.run("coverage", speccheck.check_coverage)
    assert rep.failures == 1 and "init[oracle].head" in rep.results[0]["detail"]


def test_count_syncs_counts_nothing_on_the_cpu():
    with sentinels.count_syncs() as c:
        torch.arange(10).sum().item()
    assert c.count == 0
    assert sentinels.assert_syncs_at_most(lambda: 3, 0) == (3, 0)


def test_count_syncs_restores_the_mode_after_an_exception(monkeypatch):
    """With a card, the block runs in "warn" mode, counts the synchronising
    warnings and puts the earlier mode back, also when the body raises."""
    import warnings

    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", {"warn": 1}.get(m, m)))
    with sentinels.count_syncs() as c:
        assert mode["now"] == 1
        warnings.warn("Synchronization debug mode is a prototype feature and does not "
                      "yet detect all synchronizing operations")  # torch's one-time notice
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
    assert c.count == 1 and mode["now"] == 0
    assert list(c.sites.values()) == [1] and next(iter(c.sites)).startswith(
        "test_torch_analysis.py:")
    with pytest.raises(ValueError):
        with sentinels.count_syncs():
            warnings.warn("called a synchronizing CUDA operation")
            raise ValueError("the body fails")
    assert mode["now"] == 0

    def two_syncs():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("called a synchronizing CUDA operation")

    with pytest.raises(AssertionError, match="2 host syncs, at most 1"):
        sentinels.assert_syncs_at_most(two_syncs, 1, "two")
    assert mode["now"] == 0


def test_step_syncs_pin_covers_every_rule():
    assert set(sentinels.STEP_SYNCS_PER_ROUND) == set(rt.RULES) == set(RULES)
    assert set(sentinels.SEGMENT_EXTRA_SYNCS) == set(RULES)


# ---------------------------------------------------------------------------
# trace files
# ---------------------------------------------------------------------------


def _jobs(wl) -> list:
    return [(j.job_id, j.submit_time, list(j.durations), j.estimated_duration)
            for j in wl.jobs]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_json_traces_cross_between_the_packages(tmp_path, writer):
    wl = synth.synthetic_trace(num_jobs=12, tasks_per_job=5, load=0.6, num_workers=64, seed=3)
    jwl = jax_synth.synthetic_trace(num_jobs=12, tasks_per_job=5, load=0.6, num_workers=64,
                                    seed=3)
    path = tmp_path / "trace.json"
    if writer == "port":
        traces.save_workload(wl, path)
    else:
        jax_traces.save_workload(jwl, path)
    ours, theirs = traces.load_workload(path), jax_traces.load_workload(path)
    assert ours.name == theirs.name == "trace"
    assert _jobs(ours) == _jobs(theirs) == _jobs(jax_traces.load_workload(path))
    assert [(j.submit_time, list(j.durations)) for j in ours.jobs] == [
        (j.submit_time, list(j.durations)) for j in wl.sorted_jobs()]


def test_csv_traces_load_alike(tmp_path):
    """The Sparrow/Eagle simulator's CSV layout (``submit,dur dur ...``,
    blank lines skipped).  Neither package writes CSV (``save_workload``
    writes JSON), so the file is written here and read by both."""
    rng = np.random.default_rng(5)
    rows = [f"{s:.6f},{' '.join(f'{d:.4f}' for d in rng.exponential(1.0, k))}"
            for s, k in zip(np.cumsum(rng.exponential(0.3, 9)), rng.integers(1, 6, 9))]
    path = tmp_path / "sim.csv"
    path.write_text("\n".join(rows[:4] + [""] + rows[4:] + ["7.5"]) + "\n")
    ours, theirs = traces.load_workload(path), jax_traces.load_workload(path)
    assert _jobs(ours) == _jobs(theirs)
    assert ours.num_jobs == 10 and ours.jobs[-1].durations == []
    assert ours.num_tasks == theirs.num_tasks


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_sweep_draws(qs) -> dict:
    """The reference's seed-0 draws for section 2's megha and sparrow."""
    key = jax.random.PRNGKey(0)
    plan = jax_sweep.fig2_plan("megha", **qs.SWEEP_SMALL, **qs.MEGHA_KW)
    orders = torch.from_numpy(np.array(jax_megha.gm_orders(key, plan.cfg)))[None]
    plan = jax_sweep.fig2_plan("sparrow", **qs.SWEEP_SMALL)
    kmax = jax_state.probe_edge_layout(plan.cfg, plan.tasks)[3]
    targets = torch.from_numpy(np.array(
        jax_sparrow.probe_targets(key, plan.cfg, plan.tasks, kmax)))[None]
    return {"megha": {"orders": orders}, "sparrow": {"targets": targets}}


def test_quickstart_runs_small_on_the_cpu_and_matches_the_reference(capsys):
    qs = _quickstart()
    out = qs.main("cpu", small=True, draws=_ref_sweep_draws(qs))
    text = capsys.readouterr().out
    assert "no card, so the plain version only" in text and text.rstrip().endswith("done.")
    assert out["kernel"] == dict(device="cpu", kernel_launches=0, equal=True, placed=1000)

    # section 1: the event backend, job for job the reference's
    jwl = jax_synth.yahoo_like_trace(**qs.TRACE_SMALL)
    for sched, s in out["events"].items():
        want = jax_run_simulation(sched, jwl, num_workers=qs.TRACE_SMALL["num_workers"])
        assert s == want.summary(), sched

    # section 2: the simx grid point, counters exact and delays at rtol 1e-5
    for sched, got in out["sweep"].items():
        kw = qs.MEGHA_KW if sched == "megha" else {}
        want = jax_sweep.fig2_sweep(sched, **qs.SWEEP_SMALL, **kw)
        for k in ("tasks_done", "jobs_done", "messages", "probes", "inconsistencies"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{sched} {k}")
        for k in ("p50", "p95", "mean", "mean_util", "inconsistency_rate"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{sched} {k}")

    # section 3: two GMs on one fleet, the reference's gm_round
    W = qs.GM_WORKERS
    orders = jax_fp.make_orders(W, num_gms=4, num_lms=4, seed=0)
    ones = jnp.ones((W,), bool)
    r1 = jax_fp.gm_round(ones, ones, orders[0], 3000, max_tasks=4096)
    r2 = jax_fp.gm_round(r1.truth, ones, orders[1], 3000, max_tasks=4096)
    assert out["consistency"] == dict(
        a_placed=int((r1.workers >= 0).sum()), a_inconsistent=int(r1.n_inconsistent),
        b_placed=int((r2.workers >= 0).sum()), b_inconsistent=int(r2.n_inconsistent),
        b_view_repaired=bool(jnp.array_equal(r2.view, r2.truth)))
    assert out["consistency"]["b_inconsistent"] > 0
