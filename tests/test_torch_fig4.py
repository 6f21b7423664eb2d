"""The port's Fig. 4 sweep (``repro_torch.simx.sweep.fig4_sweep`` and its
batched fault grid) against the JAX reference on the CPU, for all five
rules.

The port is fed the reference's draws of each seed.  Grid summaries are
held at the reference's own sweep tolerance (counters exact, delays and
utilisation at rtol 1e-5); every grid point is held bitwise against the
port's run of that point alone under its schedule row, and the
zero-severity row bitwise against the fault-free grid of the same trace."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import megha as jax_megha
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import sweep as jax_sweep
from repro_torch.simx import FaultPlan, FaultSchedule, convert, fig4_plan, fig4_sweep, sweep
from repro_torch.simx import runtime as rt

RULES = ["megha", "sparrow", "eagle", "pigeon", "oracle"]
#: the reference's Fig. 4 test grid (tests/test_simx_faults.py): 2
#: severities x 2 seeds on 256 workers, megha with one GM down as well
GRID = dict(fractions=(0.0, 0.25), num_seeds=2, num_workers=256, num_jobs=12,
            tasks_per_job=64, outage=2.0, gm_outages=1, dt=0.05, num_gms=4, num_lms=4,
            heartbeat_interval=1.0)
SEEDS = (0, 1)
INT_KEYS = ("jobs_done", "tasks_done", "lost", "messages", "probes", "inconsistencies",
            "res_overflow", "probe_lag")
FLOAT_KEYS = ("p50", "p95", "mean", "mean_util", "inconsistency_rate")
ANNOTATE = ("fractions", "fail_time", "outage", "num_rounds", "num_tasks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: a round is a few hundred small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same(ours: dict, theirs: dict):
    assert ours.keys() == theirs.keys()
    for name, want in theirs.items():
        got = ours[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _ref_point_draws(name, jcfg, jtasks, seed):
    """The reference's draws of ``simulate_fixed(name, ..., seed)``."""
    key = jax.random.PRNGKey(seed)
    if name == "megha":
        return {"orders": _t(jax_megha.gm_orders(key, jcfg))}
    if name == "sparrow":
        kmax = jax_state.probe_edge_layout(jcfg, jtasks)[3]
        return {"targets": _t(jax_sparrow.probe_targets(key, jcfg, jtasks, kmax))}
    if name == "eagle":
        k1, k2, k3 = jax.random.split(key, 3)
        kmax = jax_state.probe_edge_layout(jcfg, jtasks, short_only=True)[3]
        J = jtasks.num_jobs
        return {"targets": _t(jax_sparrow.probe_targets(k1, jcfg, jtasks, kmax)),
                "off1": _t(jax.random.randint(k2, (J,), 0, jcfg.num_workers, jnp.int32)),
                "off2": _t(jax.random.randint(k3, (J,), 0, jcfg.short_reserved, jnp.int32))}
    return None


@pytest.fixture(scope="module")
def grids():
    """Per rule: the reference's plan and sweep, and the port's plan fed
    the reference's draws (cached, with the port's runs)."""
    out = {}
    for name in RULES:
        jplan = jax_sweep.fig4_plan(name, **GRID)
        per_seed = [_ref_point_draws(name, jplan.cfg, jplan.tasks, s) for s in SEEDS]
        draws = (None if per_seed[0] is None else
                 {k: torch.stack([d[k] for d in per_seed]) for k in per_seed[0]})
        out[name] = dict(jplan=jplan, draws=draws,
                         plan=fig4_plan(name, draws=draws, device="cpu", **GRID))
    return out


def _fault_grid(g):
    if "state" not in g:
        p = g["plan"]
        g["state"], g["step"] = sweep.fault_grid_state(
            p.name, p.cfg, p.tasks, p.schedules, p.seeds, p.num_rounds, draws=p.draws)
    return g["state"]


def _row(schedules: FaultSchedule, f: int) -> FaultSchedule:
    return FaultSchedule(**{k.name: getattr(schedules, k.name)[f]
                            for k in dataclasses.fields(FaultSchedule)})


@pytest.mark.parametrize("name", RULES)
def test_fig4_plan_matches_reference(grids, name):
    g = grids[name]
    jp, p = g["jplan"], g["plan"]
    assert p.num_rounds == jp.num_rounds and p.cfg.num_workers == jp.cfg.num_workers
    for f in dataclasses.fields(FaultSchedule):
        np.testing.assert_array_equal(getattr(p.schedules, f.name).numpy(),
                                      np.asarray(getattr(jp.schedules, f.name)), err_msg=f.name)
    for k in ANNOTATE:
        np.testing.assert_array_equal(p.annotate[k], jp.annotate[k], err_msg=k)
    assert p.seeds == SEEDS
    if name == "megha":
        assert int(torch.isfinite(p.schedules.gm_down[1]).sum()) == 1
    else:
        assert not bool(torch.isfinite(p.schedules.gm_down).any())


@pytest.mark.parametrize("name", RULES)
def test_fig4_sweep_matches_reference(grids, name):
    """``fig4_sweep`` against ``repro.simx.sweep.fig4_sweep``: every summary
    key and annotation; nothing lost at severity 0, something at 0.25."""
    g = grids[name]
    want = jax_sweep.fig4_sweep(name, **GRID)
    got = fig4_sweep(name, draws=g["draws"], device="cpu", **GRID)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ANNOTATE:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert set(want) == set(got)
    assert got["p50"].shape == (2, 2)
    assert (got["tasks_done"] == int(got["num_tasks"])).all()
    assert (got["lost"][0] == 0).all() and (got["lost"][1] > 0).all()


@pytest.mark.parametrize("name", RULES)
def test_fig4_grid_point_is_bitwise_its_run_alone(grids, name):
    g = grids[name]
    p = g["plan"]
    batched = convert.state_to_numpy(_fault_grid(g))
    for f, s in ((1, 1), (1, 0)):
        draws = p.draws and {k: v[s] for k, v in p.draws.items()}
        alone = rt.simulate_fixed(name, p.cfg, p.tasks, draws if draws else 0, p.num_rounds,
                                  faults=_row(p.schedules, f))
        assert alone.t.dim() == 0 and int(alone.lost) > 0
        _assert_same({k: v[f * len(SEEDS) + s] for k, v in batched.items()},
                     convert.state_to_numpy(alone))


@pytest.mark.parametrize("name", RULES)
def test_zero_severity_row_is_bitwise_the_fault_free_grid(grids, name):
    """The severity-0 points run the fault program with an all-inf row;
    they equal the points of the fault-free grid of the same trace."""
    g = grids[name]
    p = g["plan"]
    faulted = convert.state_to_numpy(_fault_grid(g))
    clean, _, _ = sweep.grid_state(name, p.cfg, p.tasks, p.tasks.submit[None],
                                   p.tasks.job_submit[None], p.seeds, p.num_rounds,
                                   draws=p.draws)
    clean = convert.state_to_numpy(clean)
    for s in range(len(SEEDS)):
        _assert_same({k: v[s] for k, v in faulted.items()}, {k: v[s] for k, v in clean.items()})


def test_eagle_bounces_probes_off_dead_workers_on_the_grid(grids):
    """Under faults eagle keeps SSS on the synthetic trace, so dead workers
    bounce its probes: at severity 0 its probe count is sparrow's, above
    it eagle's exceeds sparrow's by the re-routed edges."""
    s, e = (convert.state_to_numpy(_fault_grid(grids[n]))["probes"] for n in ("sparrow", "eagle"))
    np.testing.assert_array_equal(e[:2], s[:2])
    assert (e[2:] > s[2:]).all()


def test_fault_grid_needs_a_severity_axis(grids):
    p = grids["oracle"]["plan"]
    with pytest.raises(ValueError, match="severity axis"):
        sweep.fault_sweep_grid("oracle", p.cfg, p.tasks, _row(p.schedules, 0), SEEDS, 5)
    sched = FaultPlan().to_schedule(p.cfg.num_workers, p.cfg.num_gms, p.cfg.dt)
    assert sched.batch is None and p.schedules.batch == 2


def test_fig4_memory_guard_fails_fast():
    with pytest.raises(RuntimeError, match="mem_limit_gb"):
        fig4_sweep("eagle", fractions=(0.0, 0.1), num_seeds=2, num_workers=50_000,
                   num_jobs=480, tasks_per_job=1000, mem_limit_gb=0.001, device="cpu")


def test_fig4_sweep_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig4_sweep("oracle", num_workers=64, num_jobs=2, tasks_per_job=4)
