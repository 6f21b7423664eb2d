"""The port's Fig. 2 sweep (``repro_torch.simx.sweep``) and pigeon rule
(``repro_torch.simx.pigeon``) against the JAX reference on the CPU.

The reference runs with its default ``use_pallas=False`` (the jnp path its
Pallas kernel is pinned to); megha is fed the reference's GM orders.
Grid summaries are held at the reference's own sweep tolerance (counters
exact, delays and utilisation at rtol 1e-5: ``nanquantile`` and the
summation order differ from XLA's); every grid point is held bitwise
against the port's run of that point alone, and pigeon's single run
bitwise against the reference's."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import engine as jax_engine
from repro.simx import export_workload as jax_export_workload
from repro.simx import megha as jax_megha
from repro.simx import pigeon as jax_pigeon
from repro.simx import runtime as jax_rt
from repro.simx import simulate_workload as jax_simulate_workload
from repro.simx import sweep as jax_sweep
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import (
    PigeonState,
    SimxConfig,
    convert,
    engine,
    fig2_plan,
    fig2_sweep,
    megha,
    pigeon,
    simulate_workload,
    sweep,
)
from repro_torch.simx import runtime as rt
from repro_torch.simx.state import export_workload, init_pigeon_state
from repro_torch.workload import synth, traces

#: tests/test_simx.py's small grid: 2 loads x 2 seeds on 64 workers
SMALL = dict(loads=(0.5, 0.8), num_jobs=8, tasks_per_job=16, num_workers=64, seed=11)
SMALL_CFG = dict(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)
SEEDS = (0, 1)
#: bench_simx.py's default Fig. 2 grid (SWEEP)
BENCH_SWEEP = dict(loads=(0.4, 0.8), num_seeds=2, num_workers=1024, num_jobs=32,
                   tasks_per_job=128, dt=0.05)
#: tests/test_torch_simx.py's parity trace
PARITY = dict(num_jobs=40, tasks_per_job=64, load=0.8, num_workers=256, seed=7)
RULES = ["megha", "pigeon", "oracle"]
INT_KEYS = ("jobs_done", "tasks_done", "lost", "messages", "probes", "inconsistencies",
            "res_overflow", "probe_lag")
FLOAT_KEYS = ("p50", "p95", "mean", "mean_util", "inconsistency_rate")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch work on one intra-op thread: a round is a
    few hundred small ops, which threads do not speed up, and under
    parallel test workers extra threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same(ours: dict, theirs: dict):
    assert ours.keys() == theirs.keys()
    for name, want in theirs.items():
        got = ours[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_summary_close(ours: dict, theirs: dict):
    """Every reference ``point_summary`` key: counters exact, the rest at
    the reference's sweep tolerance."""
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(theirs[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert set(theirs) - {"loads", "num_rounds", "num_tasks"} == set(INT_KEYS + FLOAT_KEYS)
    assert set(theirs) <= set(ours)


def _ref_orders(jcfg, seeds):
    return torch.stack([_t(jax_megha.gm_orders(jax.random.PRNGKey(s), jcfg)) for s in seeds])


@pytest.fixture(scope="module")
def small_grid():
    """The reference's small grid and its port counterpart (same arrays)."""
    loads = SMALL["loads"]
    kw = {k: v for k, v in SMALL.items() if k != "loads"}
    jtasks, jsub, jjsub = jax_sweep.make_load_grid(loads, **kw)
    jcfg, cfg = JaxSimxConfig(**SMALL_CFG), SimxConfig(**SMALL_CFG)
    rounds = max(
        jax_engine.estimate_rounds(
            jcfg, dataclasses.replace(jtasks, submit=jsub[i], job_submit=jjsub[i]))
        for i in range(len(loads))
    )
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jtasks=jtasks, jsub=jsub, jjsub=jjsub, rounds=rounds,
                tasks=tasks, sub=_t(jsub), jsub_t=_t(jjsub),
                orders=_ref_orders(jcfg, SEEDS))


def _port_grid(g, name):
    """The port's batched grid run of ``name`` (cached per module)."""
    key = ("grid", name)
    if key not in g:
        orders = g["orders"] if name == "megha" else None
        g[key] = sweep.grid_state(name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                                  g["rounds"], orders=orders)
    return g[key]


def _port_alone(g, name, li, si):
    """The port's ``simulate_fixed`` of grid point (load li, seed si) run
    alone, unbatched (cached per module)."""
    key = ("alone", name, li, si)
    if key not in g:
        tk = g["tasks"].replace(submit=g["sub"][li], job_submit=g["jsub_t"][li])
        g[key] = rt.simulate_fixed(
            name, g["cfg"], tk, g["orders"][si] if name == "megha" else SEEDS[si],
            g["rounds"])
    return g[key]


#: the points held against their runs alone: one per load, both seeds
#: (load 0.5 never borrows, load 0.8 does)
ALONE_POINTS = ((0, 1), (1, 0))


# ---------------------------------------------------------------------------
# the grid against the reference
# ---------------------------------------------------------------------------


def test_make_load_grid_matches_reference():
    loads = SMALL["loads"]
    kw = {k: v for k, v in SMALL.items() if k != "loads"}
    jtasks, jsub, jjsub = jax_sweep.make_load_grid(loads, **kw)
    tasks, sub, jsub_t = sweep.make_load_grid(loads, device="cpu", **kw)
    _assert_same(convert.state_to_numpy(tasks), _np(jtasks))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
    np.testing.assert_array_equal(jsub_t.numpy(), np.asarray(jjsub))


@pytest.mark.parametrize("name", RULES)
def test_sweep_grid_matches_reference(small_grid, name):
    g = small_grid
    want = jax_sweep.sweep_grid(name, g["jcfg"], g["jtasks"], g["jsub"], g["jjsub"],
                                jnp.arange(len(SEEDS)), g["rounds"])
    orders = g["orders"] if name == "megha" else None
    got = sweep.sweep_grid(name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                           g["rounds"], orders=orders)
    assert got["p50"].shape == (2, 2)
    assert set(want) <= set(got)
    _assert_summary_close({k: v.numpy() for k, v in got.items()}, want)
    assert (got["tasks_done"] == g["tasks"].num_tasks).all()


@pytest.mark.parametrize("name", RULES)
def test_grid_point_is_bitwise_its_run_alone(small_grid, name):
    """Each point of the batched grid equals ``simulate_fixed`` of that
    point run alone, every field of the final state bitwise."""
    g = small_grid
    state, _, _ = _port_grid(g, name)
    batched = convert.state_to_numpy(state)
    for li, si in ALONE_POINTS:
        alone = _port_alone(g, name, li, si)
        assert alone.t.dim() == 0
        point = {k: v[li * len(SEEDS) + si] for k, v in batched.items()}
        _assert_same(point, convert.state_to_numpy(alone))


def test_borrow_counts_split_between_points(small_grid):
    """On the small grid the load-0.8 points run megha's borrow pass and
    the load-0.5 points never do; the per-point counts show the split."""
    state, _, step = _port_grid(small_grid, "megha")
    per_point = step.point_borrow_rounds.tolist()
    assert per_point[:2] == [0, 0] and min(per_point[2:]) > 0
    assert step.borrow_rounds == max(per_point)
    alone = _port_alone(small_grid, "megha", 1, 0)
    assert int(alone.inconsistencies) == int(state.inconsistencies[2])


def _select_case():
    """Two points of one trace on 64 workers (4 GMs x 4 LMs) whose borrow
    rounds differ.  Job j goes to GM j % 4: GM0 gets 48 two-second tasks,
    GMs 1-3 four half-second tasks each.  Point 0: GM0's job at t = 0, so
    it borrows into the other GMs' partitions and at t = 0.1 GMs 1-3
    propose onto their stale views (inconsistent proposals, yet no queue
    outruns its internal view: the point does not need the borrow pass).
    Point 1: every job at t = 0.1, so GM0 needs the pass in that round."""
    jobs = [traces.Job(job_id=0, submit_time=0.0, durations=[2.0] * 48)] + [
        traces.Job(job_id=j, submit_time=0.1, durations=[0.5] * 4) for j in (1, 2, 3)]
    tasks = export_workload(traces.Workload(name="select", jobs=jobs), "cpu")
    jsub = torch.tensor([[0.0, 0.1, 0.1, 0.1], [0.1, 0.1, 0.1, 0.1]])
    return tasks, jsub[:, tasks.job.long()], jsub


def test_borrow_select_keeps_points_that_did_not_need_the_pass():
    """In a round where one point enters the borrow pass and another does
    not, the pass still runs for both (one launch for the batch), and the
    point that did not need it would re-propose its inconsistent tasks in
    it; the select keeps its old values, so each point equals its run
    alone, bitwise.  (Without the select, point 0 here differs.)"""
    tasks, sub, jsub = _select_case()
    cfg = SimxConfig(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)
    orders = megha.gm_orders(torch.Generator().manual_seed(0), cfg)
    state, _, step = sweep.grid_state("megha", cfg, tasks, sub, jsub, (0,), 200,
                                      orders=orders[None])
    per_point = step.point_borrow_rounds.tolist()
    assert step.borrow_rounds > max(per_point) > 0  # rounds where only one point borrowed
    assert min(state.inconsistencies.tolist()) > 0
    batched = convert.state_to_numpy(state)
    for b in range(2):
        alone = rt.simulate_fixed(
            "megha", cfg, tasks.replace(submit=sub[b], job_submit=jsub[b]), orders, 200)
        assert int(torch.sum(alone.task_finish <= alone.t)) == tasks.num_tasks
        _assert_same({k: v[b] for k, v in batched.items()}, convert.state_to_numpy(alone))


def test_fig2_sweep_megha_matches_reference_on_the_bench_grid():
    """``bench_simx.py``'s default Fig. 2 grid, the reference re-derived
    here on the same tree: every summary key, the round budget and the
    load annotation."""
    want = jax_sweep.fig2_sweep("megha", **BENCH_SWEEP)
    jcfg = JaxSimxConfig(num_workers=BENCH_SWEEP["num_workers"], dt=BENCH_SWEEP["dt"])
    got = fig2_sweep("megha", orders=_ref_orders(jcfg, range(BENCH_SWEEP["num_seeds"])),
                     device="cpu", **BENCH_SWEEP)
    assert int(got["num_rounds"]) == int(want["num_rounds"])
    assert int(got["num_tasks"]) == int(want["num_tasks"]) == 32 * 128
    np.testing.assert_array_equal(got["loads"], want["loads"])
    _assert_summary_close(got, want)
    assert (got["tasks_done"] == 32 * 128).all() and got["inconsistencies"].sum() > 0


def test_fig2_plan_shaves_megha_only_and_builds_the_trace_there():
    kw = dict(loads=(0.5,), num_seeds=1, num_workers=1000, num_jobs=2, tasks_per_job=4,
              device="cpu")
    megha, orc, pig = (fig2_plan(n, **kw) for n in RULES[::2] + ["pigeon"])
    assert megha.cfg.num_workers == 960 and orc.cfg.num_workers == pig.cfg.num_workers == 1000
    want = jax_sweep.fig2_plan("megha", loads=(0.5,), num_seeds=1, num_workers=1000,
                               num_jobs=2, tasks_per_job=4)
    np.testing.assert_array_equal(megha.submit_grid.numpy(), np.asarray(want.submit_grid))
    assert megha.num_rounds == want.num_rounds


def test_default_orders_are_those_of_a_standalone_run():
    """With no ``orders``, seed s draws ``gm_orders`` from
    ``torch.Generator().manual_seed(s)``, as ``simulate_workload(seed=s)``
    does, so a grid point and the standalone run of that seed agree."""
    kw = dict(num_jobs=6, tasks_per_job=16, load=0.8, num_workers=64, seed=2)
    cfg_kw = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, dt=0.02)
    plan = fig2_plan("megha", loads=(0.8,), num_seeds=2, num_workers=64, num_jobs=6,
                     tasks_per_job=16, trace_seed=2, device="cpu", **cfg_kw)
    state, _, _ = sweep.grid_state(plan.name, plan.cfg, plan.tasks, plan.submit_grid,
                                   plan.job_submit_grid, plan.seeds, plan.num_rounds)
    for s in plan.seeds:
        run = simulate_workload("megha", synth.synthetic_trace(**kw), 64, seed=s,
                                device="cpu", **cfg_kw)
        assert run.tasks_completed == 96
        assert int(state.inconsistencies[s]) == int(run.state.inconsistencies)
        assert int(state.repartitions[s]) == int(run.state.repartitions)
        np.testing.assert_array_equal(state.task_finish[s].numpy(),
                                      run.state.task_finish.numpy())


@pytest.mark.parametrize("slack", [1.0, 2.5, 4.0, 8.0])
def test_estimate_rounds_slack_matches_reference(slack):
    jtasks = jax_export_workload(jax_synth.synthetic_trace(**PARITY))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    kw = dict(num_workers=256, dt=0.01, heartbeat_interval=1.0)
    assert engine.estimate_rounds(SimxConfig(**kw), tasks, slack=slack) == \
        jax_engine.estimate_rounds(JaxSimxConfig(**kw), jtasks, slack=slack)


def test_sweep_refuses_unknown_rules():
    with pytest.raises(ValueError, match="implements"):
        fig2_sweep("omega", num_workers=64, num_jobs=2, tasks_per_job=4, device="cpu")


def test_sweep_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig2_sweep("oracle", num_workers=64, num_jobs=2, tasks_per_job=4)


# ---------------------------------------------------------------------------
# the point axis of the runtime helpers
# ---------------------------------------------------------------------------


def _helper_points(name: str, rng: np.random.Generator):
    """(batched args, per-point args list) for one helper over 3 points."""
    T, B = 40, 3
    fin = rng.uniform(0, 5, (B, T)).astype(np.float32)
    fin[rng.random((B, T)) < 0.4] = np.inf
    if name == "slice_rows":
        mat = rng.integers(0, 99, (1, 4, 40)).astype(np.int32)
        starts = rng.integers(0, 30, (B, 4)).astype(np.int32)
        return (mat, starts, 10), [(mat[0], starts[b], 10) for b in range(B)]
    if name == "window_launched":
        fpad = np.concatenate([fin, np.full((B, 1), -np.inf, np.float32)], 1)
        wtask = rng.integers(0, T + 1, (B, 4, 12)).astype(np.int32)
        return (fpad, wtask, T), [(fpad[b], wtask[b], T) for b in range(B)]
    if name == "finish_pad":
        return (fin,), [(fin[b],) for b in range(B)]
    if name == "apply_launch":
        launch = rng.random((B, 32)) < 0.5
        pick = np.stack([np.where(launch[b], rng.permutation(T)[:32], T)
                         for b in range(B)]).astype(np.int32)
        start = rng.uniform(0, 2, B).astype(np.float32)
        dur = np.append(rng.uniform(0, 1, T), 0).astype(np.float32)
        wf = rng.uniform(-1, 3, (B, 32)).astype(np.float32)
        wt = rng.integers(0, T + 1, (B, 32)).astype(np.int32)
        return ((launch, pick, start, dur, fin, wf, wt, T),
                [(launch[b], pick[b], start[b], dur, fin[b], wf[b], wt[b], T)
                 for b in range(B)])
    if name == "completion_masks":
        wf = rng.uniform(0, 2, (B, 64)).astype(np.float32)
        t = np.array([0.5, 1.0, 1.5], np.float32)
        return (wf, t, 0.05), [(wf[b], t[b], 0.05) for b in range(B)]
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["slice_rows", "window_launched", "finish_pad", "apply_launch", "completion_masks"])
def test_helper_on_a_point_axis_is_each_point_alone(name):
    batched, points = _helper_points(name, np.random.default_rng(3))

    def call(args):
        out = getattr(rt, name)(*(_t(a) if isinstance(a, (np.ndarray, np.generic)) else a
                                  for a in args))
        return out if isinstance(out, tuple) else (out,)

    got = call(batched)
    for b, args in enumerate(points):
        for g, w in zip(got, call(args)):
            assert torch.equal(g[b], w), (name, b)


def test_job_delays_on_a_point_axis_is_each_point_alone(small_grid):
    g = small_grid
    state, point_tasks, _ = _port_grid(g, "pigeon")
    delays, finish = rt.job_delays_from_state(state.task_finish, state.t, point_tasks)
    for b in range(4):
        tk = g["tasks"].replace(submit=point_tasks.submit[b],
                                job_submit=point_tasks.job_submit[b])
        d, f = rt.job_delays_from_state(state.task_finish[b], state.t[b], tk)
        assert torch.equal(d, delays[b]) or torch.equal(d.isnan(), delays[b].isnan())
        assert torch.equal(f, finish[b])


# ---------------------------------------------------------------------------
# pigeon against the reference
# ---------------------------------------------------------------------------


def _mixed_trace(m):
    """Short and long jobs in one trace (module ``m``'s ``Job`` /
    ``Workload``), so both of pigeon's priority classes and its WFQ split
    run: 24 jobs of 4-24 tasks, every fourth one long (11-13 s, estimate
    above the 10 s threshold), the rest 0.2-1.5 s."""
    import random

    rng = random.Random(5)
    jobs, t = [], 0.0
    for i in range(24):
        n = rng.randint(4, 24)
        lo, hi = (11.0, 13.0) if i % 4 == 1 else (0.2, 1.5)
        jobs.append(m.Job(job_id=i, submit_time=t,
                          durations=[rng.uniform(lo, hi) for _ in range(n)]))
        t += rng.expovariate(4.0)
    return m.Workload(name="mixed", jobs=jobs)


@pytest.fixture(scope="module")
def pigeon_parity():
    """The reference's pigeon run of the parity trace to completion and
    the port's ``simulate_fixed`` of the same number of rounds."""
    W = PARITY["num_workers"]
    ref_run = jax_simulate_workload("pigeon", jax_synth.synthetic_trace(**PARITY), W, dt=0.01)
    rounds = int(ref_run.state.rnd)
    cfg = SimxConfig(num_workers=W, dt=0.01)
    tasks = convert.tasks_from_numpy(_np(ref_run.tasks), "cpu")
    return ref_run, rounds, cfg, tasks, rt.simulate_fixed("pigeon", cfg, tasks, 0, rounds)


def test_pigeon_simulate_fixed_matches_reference_on_the_parity_trace(pigeon_parity):
    ref_run, rounds, cfg, tasks, got = pigeon_parity
    jcfg = JaxSimxConfig(num_workers=cfg.num_workers, dt=cfg.dt)
    want = jax_rt.simulate_fixed("pigeon", jcfg, ref_run.tasks, 0, rounds)
    assert isinstance(got, PigeonState)
    _assert_same(convert.state_to_numpy(got), _np(want))
    _assert_same(convert.state_to_numpy(got), _np(ref_run.state))
    assert int(torch.sum(got.task_finish <= got.t)) == tasks.num_tasks


def test_pigeon_simulate_fixed_matches_reference_on_mixed_priorities():
    """Reserved workers, both FIFOs and the WFQ split, for as many rounds
    as the reference's run to completion takes."""
    kw = dict(group_size=20, reserved_per_group=3, dt=0.05)
    ref_run = jax_simulate_workload("pigeon", _mixed_trace(jax_traces), 100, **kw)
    rounds = int(ref_run.state.rnd)
    jcfg = JaxSimxConfig(num_workers=100, **kw)
    want = jax_rt.simulate_fixed("pigeon", jcfg, ref_run.tasks, 0, rounds)
    tasks = export_workload(_mixed_trace(traces), "cpu")
    _assert_same(convert.state_to_numpy(tasks), _np(ref_run.tasks))
    cfg = SimxConfig(num_workers=100, **kw)
    got = rt.simulate_fixed("pigeon", cfg, tasks, 0, rounds)
    _assert_same(convert.state_to_numpy(got), _np(want))
    _assert_same(convert.state_to_numpy(got), _np(ref_run.state))
    high = tasks.job_est[tasks.job.long()] < cfg.long_threshold
    assert 0 < int(high.sum()) < tasks.num_tasks  # both classes ran
    assert int(torch.sum(got.task_finish <= got.t)) == tasks.num_tasks
    assert int(got.low_head.sum()) > 0 and int(got.high_head.sum()) > 0


@pytest.mark.parametrize("trace", ["parity", "mixed"])
def test_pigeon_task_groups_match_reference(trace):
    jwl = (jax_synth.synthetic_trace(**PARITY) if trace == "parity"
           else _mixed_trace(jax_traces))
    jtasks = jax_export_workload(jwl)
    kw = dict(num_workers=256, num_distributors=3, group_size=24)
    np.testing.assert_array_equal(
        pigeon.task_groups(SimxConfig(**kw), convert.tasks_from_numpy(_np(jtasks), "cpu")),
        jax_pigeon.task_groups(JaxSimxConfig(**kw), jtasks))


def test_pigeon_ragged_last_group_matches_reference():
    """100 workers in groups of 40: the last group holds 60, the others'
    rows are padded to 60 lanes that read busy."""
    jtasks = jax_export_workload(jax_synth.synthetic_trace(
        num_jobs=8, tasks_per_job=24, load=0.9, num_workers=100, seed=4))
    kw = dict(num_workers=100, dt=0.05, heartbeat_interval=1.0)
    rounds = jax_engine.estimate_rounds(JaxSimxConfig(**kw), jtasks)
    want = jax_rt.simulate_fixed("pigeon", JaxSimxConfig(**kw), jtasks, 0, rounds)
    got = rt.simulate_fixed("pigeon", SimxConfig(**kw), convert.tasks_from_numpy(
        _np(jtasks), "cpu"), 0, rounds)
    _assert_same(convert.state_to_numpy(got), _np(want))


def test_pigeon_run_simulation_matches_reference(pigeon_parity):
    """The whole path ``run_simulation("pigeon", backend="simx")``: the
    summary (waits counted at the scheduling entity) equal to the
    reference's, from a run that stopped where the reference's did."""
    ref_run, rounds, *_ = pigeon_parity
    wl = synth.synthetic_trace(**PARITY)
    got = run_simulation("pigeon", wl, PARITY["num_workers"], backend="simx", dt=0.01,
                         device="cpu")
    want = ref_run.to_run_metrics().summary()
    summary = got.summary()
    assert summary.keys() == want.keys()
    for k in want:
        assert summary[k] == want[k] or (math.isnan(summary[k]) and math.isnan(want[k])), k
    assert got.messages == int(ref_run.state.messages)


def test_pigeon_init_state_shapes():
    cfg = SimxConfig(num_workers=100)
    one = init_pigeon_state(cfg, 7, "cpu")
    grid = init_pigeon_state(cfg, 7, "cpu", batch=3)
    assert one.high_head.shape == (cfg.num_groups,) == (2,)
    assert grid.high_head.shape == (3, 2) and grid.task_finish.shape == (3, 7)
    assert grid.t.shape == (3,) and one.t.shape == ()
