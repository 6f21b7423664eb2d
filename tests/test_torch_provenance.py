"""The port's delay provenance (``repro_torch.simx.provenance``, the
runtime's lifecycle stage and each rule's extras) against the JAX
reference on the CPU.

For each of the five rules on the mixed trace of
``tests/test_torch_faults.py`` (long and short jobs on 128 workers), with
no fault schedule and with the crash wave (megha also under GM outages):
the ``Provenance`` arrays and ``decompose_delays`` are bitwise the
reference's, the components telescope to the Eq. 2 delay at the
reference's own tolerance (``tests/test_simx_provenance.py``), and under
crashes every lost task is re-pended once and books fault rework.  Then
the Fig. 2 grid's ``mean_<component>`` columns (within rtol 1e-5, every
point bitwise its run alone), the engine's decomposition and Chrome spans
(JSON equal to the reference's), and the event backend's
``job_delay_decomposition`` record for record."""

import dataclasses
import json
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import engine as jax_engine
from repro.simx import export_workload as jax_export_workload
from repro.simx import faults as jax_faults
from repro.simx import megha as jax_megha
from repro.simx import provenance as jax_prov
from repro.simx import runtime as jax_rt
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import sweep as jax_sweep
from repro.simx import telemetry as jax_tel
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.core import metrics
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import (
    COMPONENTS,
    FaultPlan,
    Provenance,
    SimxConfig,
    WorkerFailure,
    convert,
    decompose_delays,
    faults,
    provenance,
    simulate_workload,
    sweep,
    telemetry,
)
from repro_torch.simx import runtime as rt
from repro_torch.workload import synth, traces

RULES = ["megha", "sparrow", "eagle", "pigeon", "oracle"]
CFG = dict(num_workers=128, num_gms=4, num_lms=4, dt=0.05, heartbeat_interval=1.0)
SEED = 5
ROUNDS = 320
CASES = [(n, p) for n in RULES for p in ("none", "crash_wave")] + [("megha", "gm_outage")]
#: tests/test_simx.py's small grid: 2 loads x 2 seeds on 64 workers
SMALL = dict(loads=(0.5, 0.8), num_jobs=8, tasks_per_job=16, num_workers=64, seed=11)
SMALL_CFG = dict(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)
SEEDS = (0, 1)
SMALL_ROUNDS = 400


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: a round is a few hundred small ops."""
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


def _plan(m, plan: str):
    """A fault plan of ``tests/test_torch_faults.py``, built with module
    ``m``'s plan classes."""
    kill = np.random.default_rng(0).permutation(128)
    if plan == "crash_wave":
        return m.FaultPlan(worker_failures=tuple(
            m.WorkerFailure(int(w), 2.0, 5.0) for w in kill[:32]))
    return m.FaultPlan(
        worker_failures=tuple(m.WorkerFailure(int(w), 1.5, 3.0) for w in kill[:8]),
        gm_outages=(m.GmOutage(1, 1.0, 2.5), m.GmOutage(2, 2.0, 4.0)),
        heartbeat_delay=0.5)


def _mixed(m):
    """Long + short jobs on 128 workers: 16 jobs, every fourth 8 tasks of
    12 s, the rest 32 tasks of 1 s; module ``m``'s ``Job`` / ``Workload``."""
    rng = random.Random(5)
    jobs, t = [], 0.0
    for i in range(16):
        durs = [12.0] * 8 if i % 4 == 0 else [1.0] * 32
        jobs.append(m.Job(job_id=i, submit_time=t, durations=durs))
        t += rng.expovariate(1.0 / 0.4)
    return m.Workload(name="mixed", jobs=jobs)


def _ref_draws(name, jcfg, jtasks, seed):
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
    return {}


@pytest.fixture(scope="module")
def mixed():
    jtasks = jax_export_workload(_mixed(jax_traces))
    return dict(jtasks=jtasks, jcfg=JaxSimxConfig(**CFG), cfg=SimxConfig(**CFG),
                tasks=convert.tasks_from_numpy(_np(jtasks), "cpu"), cache={})


def _runs(g, name, plan):
    """(reference, port) ``(state, Provenance)`` carries of one case."""
    key = (name, plan)
    if key not in g["cache"]:
        jfs = fs = None
        if plan != "none":
            jfs = _plan(jax_faults, plan).to_schedule(128, 4, CFG["dt"])
            fs = _plan(faults, plan).to_schedule(128, 4, CFG["dt"])
        draws = _ref_draws(name, g["jcfg"], g["jtasks"], SEED)
        g["cache"][key] = (
            jax_rt.simulate_fixed(name, g["jcfg"], g["jtasks"], SEED, ROUNDS, faults=jfs,
                                  provenance=True),
            rt.simulate_fixed(name, g["cfg"], g["tasks"], draws, ROUNDS, faults=fs,
                              provenance=True),
        )
    return g["cache"][key]


def _components_sum_to_delays(dec) -> np.ndarray:
    """The reference's telescoping check: finite exactly where done, the
    components' sum the delay (atol 1e-4)."""
    delays = np.asarray(dec["delays"], np.float64)
    done = np.isfinite(delays)
    total = np.zeros_like(delays)
    for k in COMPONENTS:
        c = np.asarray(dec[k], np.float64)
        np.testing.assert_array_equal(np.isfinite(c), done, err_msg=k)
        assert np.all(c[done] >= -1e-5), k
        total += np.where(done, c, 0.0)
    np.testing.assert_allclose(total[done], delays[done], atol=1e-4)
    return done


@pytest.mark.parametrize("name,plan", CASES)
def test_provenance_is_bitwise_the_reference(mixed, name, plan):
    (jstate, jprov), (state, prov) = _runs(mixed, name, plan)
    assert isinstance(prov, Provenance)
    _assert_same(convert.state_to_numpy(prov), _np(jprov))
    _assert_same(convert.state_to_numpy(state), _np(jstate))
    # every launch was recorded, placements in range
    launched = ~torch.isinf(state.task_finish)
    assert bool((prov.launch_round[launched] != provenance.UNSET).all())
    assert int(prov.placed_worker.max()) < CFG["num_workers"]


@pytest.mark.parametrize("name,plan", CASES)
def test_decompose_delays_is_bitwise_the_reference(mixed, name, plan):
    (jstate, jprov), (state, prov) = _runs(mixed, name, plan)
    want = jax_prov.decompose_delays(jprov, jstate.task_finish, jstate.t, mixed["jtasks"],
                                     CFG["dt"])
    got = decompose_delays(prov, state.task_finish, state.t, mixed["tasks"], CFG["dt"])
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})
    done = _components_sum_to_delays({k: v.numpy() for k, v in got.items()})
    assert done.any()


@pytest.mark.parametrize("name", RULES)
def test_crashes_requeue_each_lost_task_and_book_rework(mixed, name):
    """Under the crash wave each lost task is re-pended once
    (``requeue_count`` sums to ``lost``) and the run books fault rework;
    without faults neither happens."""
    _, (state, prov) = _runs(mixed, name, "crash_wave")
    assert int(prov.requeue_count.sum()) == int(state.lost) > 0
    rework = decompose_delays(prov, state.task_finish, state.t, mixed["tasks"],
                              CFG["dt"])["fault_rework"]
    assert float(torch.nansum(rework)) > 0.0
    _, (_, clean) = _runs(mixed, name, "none")
    assert int(clean.requeue_count.sum()) == 0
    assert bool((clean.first_launch_round == clean.launch_round).all())


def test_megha_books_inconsistency_retries(mixed):
    """Megha's stale views give stale-state retries, booked as the
    inconsistency_retry component; the other rules have none."""
    for name in RULES:
        _, (state, prov) = _runs(mixed, name, "none")
        retries = int(prov.stale_retry_count.sum())
        assert (retries > 0) == (name == "megha"), name
    _, (state, prov) = _runs(mixed, "megha", "none")
    dec = decompose_delays(prov, state.task_finish, state.t, mixed["tasks"], CFG["dt"])
    assert float(torch.nansum(dec["inconsistency_retry"])) > 0.0


# ---------------------------------------------------------------------------
# the Fig. 2 grid's breakdown columns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_grid():
    loads = SMALL["loads"]
    kw = {k: v for k, v in SMALL.items() if k != "loads"}
    jtasks, jsub, jjsub = jax_sweep.make_load_grid(loads, **kw)
    jcfg = JaxSimxConfig(**SMALL_CFG)
    draws = {}
    for name in RULES:
        per = [_ref_draws(name, jcfg, jtasks, s) for s in SEEDS]
        draws[name] = {k: torch.stack([d[k] for d in per]) for k in per[0]}
    return dict(jcfg=jcfg, cfg=SimxConfig(**SMALL_CFG), jtasks=jtasks, jsub=jsub, jjsub=jjsub,
                tasks=convert.tasks_from_numpy(_np(jtasks), "cpu"), sub=_t(jsub),
                jsub_t=_t(jjsub), draws=draws)


@pytest.mark.parametrize("name", RULES)
def test_sweep_grid_breakdown_matches_reference(small_grid, name):
    """``sweep_grid(provenance=True)``: every column within the reference's
    sweep tolerance (counters exact), ``mean_<component>`` summing to
    ``mean``; without the flag the columns are absent."""
    g = small_grid
    want = jax_sweep.sweep_grid(name, g["jcfg"], g["jtasks"], g["jsub"], g["jjsub"],
                                jnp.arange(len(SEEDS)), SMALL_ROUNDS, provenance=True)
    got = sweep.sweep_grid(name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                           SMALL_ROUNDS, draws=g["draws"][name], provenance=True)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    total = sum(got[f"mean_{k}"] for k in COMPONENTS)
    np.testing.assert_allclose(total.numpy(), got["mean"].numpy(), atol=1e-4)
    plain = sweep.sweep_grid(name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS,
                             SMALL_ROUNDS, draws=g["draws"][name])
    assert set(plain) == set(got) - {f"mean_{k}" for k in COMPONENTS}
    for k, v in plain.items():
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("name", RULES)
def test_grid_point_provenance_is_bitwise_its_run_alone(small_grid, name):
    """Each point's lifecycle arrays in the batched grid equal
    ``simulate_fixed(provenance=True)`` of that point alone; a grid of one
    point (B = 1) summarises bitwise as that run."""
    g = small_grid
    (state, prov), tasks, _ = sweep.grid_state(
        name, g["cfg"], g["tasks"], g["sub"], g["jsub_t"], SEEDS, SMALL_ROUNDS,
        draws=g["draws"][name], provenance=True)
    grid = convert.state_to_numpy(prov)
    for li, si in ((0, 1), (1, 0)):
        tk = g["tasks"].replace(submit=g["sub"][li], job_submit=g["jsub_t"][li])
        draws = {k: v[si] for k, v in g["draws"][name].items()}
        alone, aprov = rt.simulate_fixed(name, g["cfg"], tk, draws, SMALL_ROUNDS,
                                         provenance=True)
        _assert_same({k: v[li * len(SEEDS) + si] for k, v in grid.items()},
                     convert.state_to_numpy(aprov))
        one = sweep.sweep_grid(name, g["cfg"], g["tasks"], g["sub"][li:li + 1],
                               g["jsub_t"][li:li + 1], SEEDS[si:si + 1], SMALL_ROUNDS,
                               draws={k: v[si:si + 1] for k, v in g["draws"][name].items()},
                               provenance=True)
        want = sweep.point_summary(alone, tk, provenance=aprov, dt=g["cfg"].dt)
        assert set(one) == set(want)
        for k, v in want.items():
            assert torch.equal(one[k].reshape(()), v) or (
                torch.isnan(v) and torch.isnan(one[k]).all()), k


def test_fig2_sweep_carries_the_flag():
    kw = dict(loads=(0.5, 0.8), num_seeds=2, num_workers=64, num_jobs=8, tasks_per_job=16,
              dt=0.02, num_gms=4, num_lms=4, heartbeat_interval=1.0, device="cpu")
    plan = sweep.fig2_plan("pigeon", provenance=True, **kw)
    assert plan.provenance and not sweep.fig2_plan("pigeon", **kw).provenance
    res = sweep.fig2_sweep("pigeon", provenance=True, **kw)
    want = jax_sweep.fig2_sweep("pigeon", provenance=True,
                                **{k: v for k, v in kw.items() if k != "device"})
    for k in COMPONENTS:
        np.testing.assert_allclose(res[f"mean_{k}"], np.asarray(want[f"mean_{k}"]),
                                   rtol=1e-5, atol=1e-6)
    tasks = sweep.make_load_grid((0.5,), num_jobs=2, tasks_per_job=4, num_workers=64,
                                 device="cpu")[0]
    state, prov = rt.simulate_fixed("pigeon", SimxConfig(num_workers=64), tasks, 0, 10,
                                    provenance=True)
    with pytest.raises(ValueError, match="dt"):
        sweep.point_summary(state, tasks, provenance=prov)


# ---------------------------------------------------------------------------
# the engine: decomposition and Chrome spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,with_faults", [("megha", False), ("sparrow", False),
                                              ("megha", True)])
def test_engine_decomposition_and_spans_match_reference(name, with_faults):
    kw = dict(num_jobs=10, tasks_per_job=24, load=0.8, num_workers=64, seed=5)
    jwl, wl = jax_synth.synthetic_trace(**kw), synth.synthetic_trace(**kw)
    cfg = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, dt=0.05)
    jplan = plan = None
    if with_faults:
        fails = [(w, 0.5 + 0.1 * w) for w in range(0, 32, 4)]
        jplan = jax_faults.FaultPlan(worker_failures=tuple(
            jax_faults.WorkerFailure(w, t) for w, t in fails))
        plan = FaultPlan(worker_failures=tuple(WorkerFailure(w, t) for w, t in fails))
    want = jax_engine.simulate_workload(name, jwl, 64, seed=3, faults=jplan, provenance=True,
                                        **cfg)
    draws = _ref_draws(name, JaxSimxConfig(num_workers=64, **cfg), jax_export_workload(jwl), 3)
    base = simulate_workload(name, wl, 64, draws=draws, faults=plan, device="cpu", **cfg)
    got = simulate_workload(name, wl, 64, draws=draws, faults=plan, provenance=True,
                            device="cpu", **cfg)
    assert base.provenance is None and got.timeline is None
    _assert_same(convert.state_to_numpy(got.state), convert.state_to_numpy(base.state))
    _assert_same(convert.state_to_numpy(got.state), _np(want.state))
    _assert_same(convert.state_to_numpy(got.provenance), _np(want.provenance))
    with pytest.raises(ValueError, match="provenance"):
        base.delay_decomposition()
    dec, jdec = got.delay_decomposition(), want.delay_decomposition()
    _assert_same(dec, jdec)
    _components_sum_to_delays(dec)
    np.testing.assert_array_equal(dec["delays"], got.job_delays())
    if with_faults:
        assert got.lost_tasks > 0 and np.nansum(dec["fault_rework"]) > 0
    assert json.dumps(got.span_events(pid=7)) == json.dumps(want.span_events(pid=7))
    for cut in (5, 0):
        ours = telemetry.provenance_spans(got.provenance, got.state, got.tasks, got.cfg, pid=2,
                                          max_tasks=cut)
        theirs = jax_tel.provenance_spans(want.provenance, want.state, want.tasks, want.cfg,
                                          pid=2, max_tasks=cut)
        assert json.dumps(ours) == json.dumps(theirs)
    spans = [e for e in got.span_events() if e["ph"] == "X"]
    assert len(spans) == 2 * got.tasks_completed


# ---------------------------------------------------------------------------
# the event backend's mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["megha", "sparrow"])
def test_job_delay_decomposition_record_for_record(scheduler):
    """The event backend's lifecycle fields and ``job_delay_decomposition``
    are the reference's, record for record, on the reference's parity
    trace; the components telescope exactly."""
    kw = dict(num_jobs=40, tasks_per_job=64, load=0.8, num_workers=256, seed=7)
    extra = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0) if scheduler == "megha" else {}
    want = jax_run_simulation(scheduler, jax_synth.synthetic_trace(**kw), num_workers=256,
                              seed=0, **extra)
    got = run_simulation(scheduler, synth.synthetic_trace(**kw), num_workers=256, seed=0,
                         **extra)
    fields = ("first_attempt_time", "first_start_time", "stale_retry_time", "stale_retries",
              "requeues", "placed_worker", "placed_entity", "start_time", "finish_time")
    assert len(got.tasks) == len(want.tasks)
    for a, b in zip(got.tasks, want.tasks):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x == y or (isinstance(x, float) and math.isnan(x) and math.isnan(y)), f
    dec, jdec = metrics.job_delay_decomposition(got), jax_metrics.job_delay_decomposition(want)
    assert metrics.PROVENANCE_COMPONENTS == jax_metrics.PROVENANCE_COMPONENTS == COMPONENTS
    assert dec.keys() == jdec.keys()
    for k in dec:
        np.testing.assert_array_equal(np.asarray(dec[k]), np.asarray(jdec[k]), err_msg=k)
    total = sum(np.asarray(dec[k]) for k in COMPONENTS)
    np.testing.assert_allclose(total, np.asarray(dec["delays"]), atol=1e-9)
    if scheduler == "megha":
        assert sum(t.stale_retries for t in got.tasks) > 0
