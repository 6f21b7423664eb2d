"""speccheck: the port's simx shape/dtype contracts, held at a small size
(port of ``repro/analysis/speccheck.py``).

``repro_torch.analysis.specs`` reads the contracts; this module shows that
the code keeps them, on every surface that builds or remaps state:

  1. **Coverage**: every known state dataclass parses all its specs and
     has no tensor field without one.
  2. **Constructors**: each registered rule's ``init`` (unbatched and with
     a point axis), ``empty_schedule``, ``init_provenance``,
     ``sketch_init`` and ``export_workload`` give the declared
     dtypes/shapes.
  3. **Step stability**: three rounds of every rule's fixed-trace step,
     unbatched and at B = 2, keep the state on spec (a ``x + 1.0`` on an
     int32 field drifts it to float32 on the first round).
  4. **Stage helpers**: ``finish_pad`` / ``sorted_fifo`` /
     ``launched_lead`` / ``completion_masks`` / ``job_delays_from_state``
     give their documented dtypes.
  5. **Streaming layouts**: each rule's ``_StreamWindow`` layout (and the
     remap after a refill) matches its specs; and a lane-stacked
     ``sharded_steady_state`` segment (3 lanes, ``num_lms`` = 2) keeps
     its state, windows, layouts and sketch on spec with the lane axis
     stripped.
  6. **Sharded drivers**: every registered rule runs a 1 x 1 grid through
     ``sharded_sweep_grid`` on a one-entry mesh (its ``GridShard`` checked
     first), and an unknown rule raises.

CLI::

    python -m repro_torch.analysis.speccheck --device cpu [--report FILE]

``--device`` defaults to the CUDA card (raising without one).  Exit 0
when every check passes, 1 with one ``CHECK ... FAIL`` line per failed
check, 2 on usage errors.  A few seconds on the CPU: the sizes are tiny
(W = 32).
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.analysis.specs import SpecError, check_state, dims_for, missing_specs, parse_spec
from repro_torch.device import resolve_device


def _known_pytrees():
    """The port's counterparts of the reference's state dataclasses."""
    from repro_torch.simx import eagle, faults, megha, pigeon, provenance, shard, sparrow
    from repro_torch.simx import state as st
    from repro_torch.simx import telemetry as tlm

    return (
        st.TaskArrays, st.CoreState, st.QueueState, st.MeghaState,
        st.SparrowState, st.EagleState, st.PigeonState, st.OracleState,
        faults.FaultSchedule, provenance.Provenance,
        megha.MeghaLayout, sparrow.ProbeLayout, eagle.EagleLayout,
        pigeon.PigeonLayout, tlm.Timeline, tlm.QuantileSketch,
        shard.GridShard,
    )


def _small_setup(device: torch.device):
    """One tiny (cfg, tasks) every check shares: W = 32 spans megha's 2 x 2
    grid, pigeon's groups and eagle's short partition."""
    from repro_torch.simx.state import SimxConfig, export_workload
    from repro_torch.workload.synth import synthetic_trace

    cfg = SimxConfig(num_workers=32, num_gms=2, num_lms=2, group_size=16)
    wl = synthetic_trace(num_jobs=8, tasks_per_job=3, load=0.5, num_workers=32, seed=0)
    return cfg, export_workload(wl, device)


class Report:
    def __init__(self) -> None:
        self.results: list[dict] = []

    def run(self, name: str, fn: Callable[[], object]) -> None:
        try:
            fn()
        except Exception as e:
            detail = (
                str(e) if isinstance(e, (SpecError, AssertionError))
                else traceback.format_exc(limit=3)
            )
            self.results.append({"check": name, "ok": False, "detail": detail})
            print(f"CHECK {name} FAIL\n  {detail}")
        else:
            self.results.append({"check": name, "ok": True})
            print(f"CHECK {name} ok")

    @property
    def failures(self) -> int:
        return sum(not r["ok"] for r in self.results)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def check_coverage() -> None:
    """Every state class: all specs parse, no tensor field without one."""
    import dataclasses

    for cls in _known_pytrees():
        gaps = missing_specs(cls)
        assert not gaps, f"{cls.__name__}: tensor fields without a spec: {gaps}"
        for f in dataclasses.fields(cls):
            text = f.metadata.get("spec")
            if text is not None:
                parse_spec(text)  # raises SpecError on a malformed string


def check_constructors(device=None) -> None:
    """Rule inits (one point and B = 2) and the shared constructors are on
    spec."""
    from repro_torch.simx import engine  # noqa: F401 (importing registers the rules)
    from repro_torch.simx import runtime as rt
    from repro_torch.simx.faults import empty_schedule
    from repro_torch.simx.provenance import init_provenance
    from repro_torch.simx.telemetry import sketch_init

    dev = resolve_device(device)
    cfg, tasks = _small_setup(dev)
    dims = dims_for(cfg, tasks)
    check_state(tasks, dict(dims), where="TaskArrays")
    for name, rule in rt.RULES.items():
        check_state(rule.init(cfg, tasks), dict(dims), where=f"init[{name}]")
        check_state(rule.init(cfg, tasks, 2), dict(dims, B=2), where=f"init[{name}, B=2]",
                    lead=("B",))
    check_state(empty_schedule(cfg.num_workers, cfg.num_gms, dev), dict(dims),
                where="empty_schedule")
    check_state(init_provenance(tasks.num_tasks, dev), dict(dims), where="Provenance")
    check_state(sketch_init(device=dev), {}, where="QuantileSketch")


def check_step_stability(device=None, rounds: int = 3) -> None:
    """Each rule's step keeps every field's dtype/shape for ``rounds``
    rounds, for one point and for a batch of two: a promotion shows on the
    first advance."""
    from repro_torch.simx import runtime as rt

    dev = resolve_device(device)
    cfg, tasks = _small_setup(dev)
    dims = dims_for(cfg, tasks)
    for name, rule in rt.RULES.items():
        step = rule.build_step(cfg, tasks, rt.rule_draws(rule, cfg, tasks, 0))
        for batch, lead in ((None, ()), (2, ("B",))):
            state = rule.init(cfg, tasks, batch)
            for r in range(rounds):
                state = step(state)
                check_state(state, dict(dims), lead=lead,
                            where=f"step[{name}, B={batch}] round {r + 1}")


def check_stage_helpers(device=None) -> None:
    """The shared stage helpers give their documented dtypes."""
    from repro_torch.simx import runtime as rt

    dev = resolve_device(device)
    cfg, tasks = _small_setup(dev)
    tf = torch.full((tasks.num_tasks,), float("inf"), dtype=torch.float32, device=dev)
    fpad = rt.finish_pad(tf)
    assert fpad.dtype == torch.float32, f"finish_pad: {fpad.dtype}, spec float32[T+1]"
    assert fpad.shape == (tasks.num_tasks + 1,), fpad.shape

    queued = torch.ones((2, 5), dtype=torch.bool, device=dev)
    fifo = rt.sorted_fifo(queued, 5)
    assert fifo.dtype == torch.int32, f"sorted_fifo: {fifo.dtype}, spec int32"
    lead = rt.launched_lead(queued)
    assert lead.dtype == torch.int32, f"launched_lead: {lead.dtype}, spec int32"

    t = torch.zeros((), dtype=torch.float32, device=dev)
    wf = torch.full((cfg.num_workers,), float("-inf"), dtype=torch.float32, device=dev)
    free, comp = rt.completion_masks(wf, t, cfg.dt)
    assert free.dtype == torch.bool and comp.dtype == torch.bool

    delays, job_finish = rt.job_delays_from_state(tf, t, tasks)
    assert delays.dtype == torch.float32, f"job_delays_from_state delays: {delays.dtype}"
    assert job_finish.dtype == torch.float32, job_finish.dtype
    assert delays.shape == (tasks.num_jobs,), delays.shape


def _stream_dims(win) -> dict:
    cfg = win.cfg
    return {"W": cfg.num_workers, "G": cfg.num_gms, "NG": cfg.num_groups,
            "T": win.T_cap, "J": win.J_cap}


def check_stream_layouts(device=None) -> None:
    """Each rule's streaming window: the first layout AND the remap after
    a refill stay on spec (the remappers rebuild these tensors on the host
    every refill), through one segment of ``stream._segment_core``, the
    body ``run_steady_state`` runs."""
    from repro_torch.simx import runtime as rt
    from repro_torch.simx import stream
    from repro_torch.simx import telemetry as tlm
    from repro_torch.workload.synth import PoissonArrivals

    dev = resolve_device(device)
    for name in rt.RULES:
        rule = rt.get_rule(name)
        cfg = stream.stream_config(name, 32, window_tasks=64, num_gms=2, num_lms=2)
        win = stream._StreamWindow(PoissonArrivals(rate=20.0, seed=0), cfg, name, 16, 64, 0, dev)
        dims = _stream_dims(win)
        tasks0 = win.tasks()
        check_state(tasks0, dict(dims), where=f"stream[{name}].tasks")
        layout = win.layout()
        if layout is not None:
            check_state(layout, dict(dims), where=f"stream[{name}].layout")
        orders = None
        if name == "megha":
            orders = rt.rule_draws(rule, cfg, tasks0, 0)["orders"].to(dev)
        seg = stream._segment_core(name, cfg, 8, rt.default_match_fn(), orders)
        state = rt.batch_state(rule.init(cfg, tasks0))
        state, sketch, _gauges, _blocks, _borrow = seg(
            state, tasks0, layout, tlm.sketch_init(device=dev, lanes=1))
        check_state(sketch, {}, where=f"stream[{name}].sketch", lead=("lanes",))
        head = int(state.probe_head[0]) if rule.has_queues else 0
        state, _stats, _ = win.refill(state, float(state.t[0]), int(state.lost[0]), head,
                                      collect_delays=False)
        check_state(state, dict(dims), where=f"stream[{name}].state@refill", lead=("B",))
        check_state(win.tasks(), dict(dims), where=f"stream[{name}].tasks@refill")
        layout = win.layout()
        if layout is not None:
            check_state(layout, dict(dims), where=f"stream[{name}].layout@refill")


def check_stream_lanes(device=None, lanes: int = 3) -> None:
    """A lane-stacked ``sharded_steady_state`` segment (``lanes`` = 3
    against ``num_lms`` = 2, so the lane axis cannot pass for ``L``): its
    state, stacked windows, stacked layouts and lane-batched sketch are on
    spec with the lane axis stripped, for every rule."""
    from repro_torch.simx import runtime as rt
    from repro_torch.simx import stream
    from repro_torch.workload.synth import PoissonArrivals

    dev = resolve_device(device)
    for name in rt.RULES:
        loop = stream._SteadyLoop(
            name, [PoissonArrivals(rate=r, seed=0) for r in (10.0, 20.0, 30.0)[:lanes]], 32,
            devices=(dev,), entry="sharded_steady_state", window_jobs=16, window_tasks=64,
            rounds_per_refill=8, num_gms=2, num_lms=2)
        dims = dict(_stream_dims(loop.wins[0]), L=2, lanes=lanes)
        lane = ("lanes",)
        check_state(stream._stack_tasks(loop.wins, dev), dict(dims), lead=lane,
                    where=f"lanes[{name}].tasks")
        if loop.wins[0].layout() is not None:
            check_state(rt.tree_join(torch.stack, [w.layout() for w in loop.wins]),
                        dict(dims), lead=lane, where=f"lanes[{name}].layout")
        seg = loop.segment()
        check_state(seg["state"], dict(dims), lead=lane, where=f"lanes[{name}].state")
        check_state(seg["sketch"], dict(dims), lead=lane, where=f"lanes[{name}].sketch")


def check_sharded_drivers(device=None) -> None:
    """The mesh-sharded executors accept exactly the registered rules:
    every ``RULES`` name runs a 1 x 1 grid through ``sharded_sweep_grid``
    on a one-entry mesh (its ``GridShard`` checked on spec first), and an
    unregistered name raises instead of falling back to a serial path."""
    from repro_torch.simx import runtime as rt
    from repro_torch.simx import shard, sweep

    dev = resolve_device(device)
    cfg, tasks = _small_setup(dev)
    submit = tasks.submit[None, :]               # one load row
    job_submit = tasks.job_submit[None, :]
    seeds = [0]
    mesh = shard.Mesh((dev,))
    for name in rt.RULES:
        draws = sweep.seed_draws(name, cfg, tasks, seeds)
        gs, rows, cols = shard.make_grid_shard(submit, job_submit, draws, len(seeds))
        check_state(gs, dict(dims_for(cfg, tasks), B=rows * cols), where=f"GridShard[{name}]")
        out = shard.sharded_sweep_grid(name, cfg, tasks, submit, job_submit, seeds, 8,
                                       mesh=mesh)
        assert out["p50"].shape == (1, 1), (name, out["p50"].shape)
    try:
        shard.sharded_sweep_grid("nosuchrule", cfg, tasks, submit, job_submit, seeds, 8,
                                 mesh=mesh)
    except ValueError:
        pass
    else:
        raise AssertionError("sharded_sweep_grid accepted an unknown rule")


def run_all(device=None) -> Report:
    """Every check on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    rep = Report()
    rep.run("coverage", check_coverage)
    rep.run("constructors", lambda: check_constructors(dev))
    rep.run("step-stability", lambda: check_step_stability(dev))
    rep.run("stage-helpers", lambda: check_stage_helpers(dev))
    rep.run("stream-layouts", lambda: check_stream_layouts(dev))
    rep.run("stream-lanes", lambda: check_stream_lanes(dev))
    rep.run("sharded-drivers", lambda: check_sharded_drivers(dev))
    return rep


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts: dict = {"--report": None, "--device": None}
    for flag in opts:
        if flag in argv:
            i = argv.index(flag)
            try:
                opts[flag] = argv[i + 1]
            except IndexError:
                print(f"speccheck: {flag} needs an argument", file=sys.stderr)
                return 2
            del argv[i : i + 2]
    if argv:
        print("usage: python -m repro_torch.analysis.speccheck [--device DEV] [--report FILE]",
              file=sys.stderr)
        return 2
    rep = run_all(opts["--device"])
    if opts["--report"]:
        Path(opts["--report"]).write_text(json.dumps(rep.results, indent=2) + "\n")
    if rep.failures:
        print(f"speccheck: {rep.failures} check(s) failed", file=sys.stderr)
        return 1
    print("speccheck: all contracts hold", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
