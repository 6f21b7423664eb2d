"""The port's Fig. 2 sweep (``repro_torch.simx.sweep``) for the
reservation-queue rules, sparrow and eagle, against the JAX reference on
the CPU.

The port is fed the reference's draws, one set per seed: the probe
targets of ``repro.simx.sparrow.probe_targets(PRNGKey(seed), ...)`` and,
for eagle, the re-route rotations of ``split(PRNGKey(seed), 3)``.  Grid
summaries are held at the reference's own sweep tolerance (counters exact,
the queue counters among them; delays and utilisation at rtol 1e-5), and
every grid point bitwise against the port's run of that point alone.  The
probe-memory estimate equals the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import engine as jax_engine
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import sweep as jax_sweep
from repro_torch.simx import SimxConfig, convert, fig2_plan, fig2_sweep, simulate_workload, sweep
from repro_torch.simx import runtime as rt
from repro_torch.workload import synth

#: test_torch_sweep.py's small grid trace (2 loads x 2 seeds on 64
#: workers), in 0.05 s rounds
SMALL = dict(loads=(0.5, 0.8), num_jobs=8, tasks_per_job=16, num_workers=64, seed=11)
SMALL_CFG = dict(num_workers=64, dt=0.05)
SEEDS = (0, 1)
#: a Fig. 2 grid for ``fig2_sweep``, a quarter of bench_simx.py's default
QUEUE_SWEEP = dict(loads=(0.4, 0.8), num_seeds=2, num_workers=256, num_jobs=16,
                   tasks_per_job=64, dt=0.05)
RULES = ["sparrow", "eagle"]
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
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(theirs[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert set(theirs) - {"loads", "num_rounds", "num_tasks"} == set(INT_KEYS + FLOAT_KEYS)


def _ref_point_draws(name, jcfg, jtasks, seed):
    """The reference's draws of ``simulate_fixed(name, ..., seed)``."""
    key = jax.random.PRNGKey(seed)
    if name == "sparrow":
        kmax = jax_state.probe_edge_layout(jcfg, jtasks)[3]
        return {"targets": _t(jax_sparrow.probe_targets(key, jcfg, jtasks, kmax))}
    k1, k2, k3 = jax.random.split(key, 3)
    kmax = jax_state.probe_edge_layout(jcfg, jtasks, short_only=True)[3]
    J = jtasks.num_jobs
    return {"targets": _t(jax_sparrow.probe_targets(k1, jcfg, jtasks, kmax)),
            "off1": _t(jax.random.randint(k2, (J,), 0, jcfg.num_workers, jnp.int32)),
            "off2": _t(jax.random.randint(k3, (J,), 0, jcfg.short_reserved, jnp.int32))}


def _ref_draws(name, jcfg, jtasks, seeds):
    """The reference's draws for a grid's seeds, each stacked ``[S, ...]``."""
    per_seed = [_ref_point_draws(name, jcfg, jtasks, s) for s in seeds]
    return {k: torch.stack([d[k] for d in per_seed]) for k in per_seed[0]}


@pytest.fixture(scope="module")
def small_grid():
    """The reference's small grid and its port counterpart (same arrays),
    with a cache of the port's runs."""
    loads = SMALL["loads"]
    kw = {k: v for k, v in SMALL.items() if k != "loads"}
    jtasks, jsub, jjsub = jax_sweep.make_load_grid(loads, **kw)
    jcfg = JaxSimxConfig(**SMALL_CFG)
    rounds = max(
        jax_engine.estimate_rounds(
            jcfg, dataclasses.replace(jtasks, submit=jsub[i], job_submit=jjsub[i]))
        for i in range(len(loads))
    )
    return dict(jcfg=jcfg, cfg=SimxConfig(**SMALL_CFG), jtasks=jtasks, jsub=jsub,
                jjsub=jjsub, rounds=rounds,
                tasks=convert.tasks_from_numpy(_np(jtasks), "cpu"), sub=_t(jsub),
                jsub_t=_t(jjsub),
                draws={n: _ref_draws(n, jcfg, jtasks, SEEDS) for n in RULES})


def _port_grid(g, name):
    key = ("grid", name)
    if key not in g:
        g[key] = sweep.grid_state(name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                                  g["rounds"], draws=g["draws"][name])
    return g[key]


@pytest.mark.parametrize("name", RULES)
def test_sweep_grid_matches_reference(small_grid, name):
    g = small_grid
    want = jax_sweep.sweep_grid(name, g["jcfg"], g["jtasks"], g["jsub"], g["jjsub"],
                                jnp.arange(len(SEEDS)), g["rounds"])
    state, point_tasks, _ = _port_grid(g, name)
    got = {k: v.reshape(2, 2).numpy()
           for k, v in sweep.point_summary(state, point_tasks).items()}
    _assert_summary_close(got, want)
    assert (got["tasks_done"] == g["tasks"].num_tasks).all() and got["probes"].min() > 0


@pytest.mark.parametrize("name", RULES)
def test_grid_point_is_bitwise_its_run_alone(small_grid, name):
    """Each point of the batched grid equals ``simulate_fixed`` of that
    point run alone with its seed's draws, every field bitwise."""
    g = small_grid
    state, _, _ = _port_grid(g, name)
    batched = convert.state_to_numpy(state)
    for li, si in ((0, 1), (1, 0)):
        tk = g["tasks"].replace(submit=g["sub"][li], job_submit=g["jsub_t"][li])
        alone = rt.simulate_fixed(name, g["cfg"], tk,
                                  {k: v[si] for k, v in g["draws"][name].items()}, g["rounds"])
        assert alone.t.dim() == 0
        _assert_same({k: v[li * len(SEEDS) + si] for k, v in batched.items()},
                     convert.state_to_numpy(alone))


@pytest.mark.parametrize("name", RULES)
def test_fig2_sweep_matches_reference(name):
    """``fig2_sweep`` for sparrow and eagle, the reference's draws fed in
    per seed: every summary key (the queue counters exact), the round
    budget and the annotations."""
    want = jax_sweep.fig2_sweep(name, **QUEUE_SWEEP)
    plan = jax_sweep.fig2_plan(name, **QUEUE_SWEEP)
    draws = _ref_draws(name, plan.cfg, plan.tasks, range(QUEUE_SWEEP["num_seeds"]))
    got = fig2_sweep(name, draws=draws, device="cpu", **QUEUE_SWEEP)
    assert int(got["num_rounds"]) == int(want["num_rounds"])
    assert int(got["num_tasks"]) == int(want["num_tasks"]) == 16 * 64
    np.testing.assert_array_equal(got["loads"], want["loads"])
    _assert_summary_close(got, want)
    assert (got["tasks_done"] == 16 * 64).all() and got["probes"].min() > 0


def test_queue_counters_reach_the_grid_summary(small_grid):
    """A probe window of 8 edges saturates: ``probe_lag`` (and the probe
    counts) per point, exactly the reference's."""
    g = small_grid
    kw = dict(SMALL_CFG, probe_window=8)
    want = jax_sweep.sweep_grid("sparrow", JaxSimxConfig(**kw), g["jtasks"], g["jsub"],
                                g["jjsub"], jnp.arange(len(SEEDS)), g["rounds"])
    got = sweep.sweep_grid("sparrow", SimxConfig(**kw), g["tasks"], g["sub"], g["jsub_t"],
                           SEEDS, g["rounds"], draws=g["draws"]["sparrow"])
    _assert_summary_close({k: v.numpy() for k, v in got.items()}, want)
    assert int(got["probe_lag"].min()) > 0


@pytest.mark.parametrize("name", ["sparrow", "eagle", "megha", "pigeon", "oracle", "omega"])
@pytest.mark.parametrize("args", [
    (480, 50_000, 6, {}), (200, 10_000, 9, dict(tasks_per_job=10, probe_ratio=3)),
    (32, 1024, 4, dict(tasks_per_job=128, reserve_cap=5)), (1, 7, 1, dict(tasks_per_job=1)),
])
def test_probe_memory_bytes_matches_reference(name, args):
    J, W, n, kw = args
    assert sweep.probe_memory_bytes(name, J, W, n, **kw) == \
        jax_sweep.probe_memory_bytes(name, J, W, n, **kw)


def test_probe_memory_guard_fails_fast():
    assert sweep.check_probe_memory("megha", 480, 50_000, 6, 1.0) == 0
    assert sweep.check_probe_memory("sparrow", 480, 50_000, 6, None) > 0
    with pytest.raises(RuntimeError, match="reservation-queue state"):
        sweep.check_probe_memory("eagle", 480, 50_000, 6, 1024.0)
    with pytest.raises(RuntimeError, match="mem_limit_gb"):
        fig2_plan("sparrow", loads=(0.5,), num_seeds=1, num_workers=64, num_jobs=2,
                  tasks_per_job=4, mem_limit_gb=1e-6, device="cpu")


@pytest.mark.parametrize("name", RULES)
def test_default_draws_are_those_of_a_standalone_run(name):
    """With no draws, seed s draws from ``torch.Generator().manual_seed(s)``
    as ``simulate_workload(seed=s)`` does, so a grid point and the
    standalone run of that seed place every task alike."""
    kw = dict(num_jobs=6, tasks_per_job=16, load=0.8, num_workers=64, seed=2)
    plan = fig2_plan(name, loads=(0.8,), num_seeds=2, num_workers=64, num_jobs=6,
                     tasks_per_job=16, trace_seed=2, device="cpu")
    state, _, _ = sweep.grid_state(plan.name, plan.cfg, plan.tasks, plan.submit_grid,
                                   plan.job_submit_grid, plan.seeds, plan.num_rounds)
    for s in plan.seeds:
        run = simulate_workload(name, synth.synthetic_trace(**kw), 64, seed=s, device="cpu")
        assert run.tasks_completed == 96
        np.testing.assert_array_equal(state.task_finish[s].numpy(),
                                      run.state.task_finish.numpy())
        assert int(state.probes[s]) == int(run.state.probes)


def test_grid_refuses_draws_of_another_shape(small_grid):
    g = small_grid
    draws = g["draws"]["sparrow"]
    with pytest.raises(ValueError, match="seeds"):
        sweep.build_grid("sparrow", g["cfg"], g["tasks"], g["sub"], g["jsub_t"], (0, 1, 2),
                         draws=draws)
    with pytest.raises(ValueError, match="draws"):
        sweep.build_grid("eagle", g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                         draws=draws)
    with pytest.raises(ValueError, match="draws"):
        sweep.build_grid("sparrow", g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                         orders=torch.zeros((2, 8, 64), dtype=torch.int32))
