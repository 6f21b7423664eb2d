"""The port's simx backend (``repro_torch.simx``) against the JAX reference
on the CPU: each runtime helper bitwise, the megha and oracle round steps
bitwise with the reference's GM orders fed in, the whole
``run_simulation(..., backend="simx")`` path bitwise on the parity trace,
and the event backend within the reference's own parity tolerance."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import percentile
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import engine as jax_engine
from repro.simx import export_workload as jax_export_workload
from repro.simx import megha as jax_megha
from repro.simx import oracle as jax_oracle
from repro.simx import runtime as jax_rt
from repro.simx import simulate_workload as jax_simulate_workload
from repro.simx.state import init_megha_state as jax_init_megha_state
from repro.simx.state import init_oracle_state as jax_init_oracle_state
from repro.workload import synth as jax_synth
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import convert, engine, megha, oracle, simulate_workload
from repro_torch.simx import runtime as rt
from repro_torch.simx.state import (
    MeghaState,
    OracleState,
    SimxConfig,
    init_megha_state,
    init_oracle_state,
)
from repro_torch.workload import synth

#: tests/test_simx.py's parity trace: 40 jobs x 64 one-second tasks at
#: load 0.8 on 256 workers, run at dt=0.01; megha at 4 GMs x 4 LMs.
PARITY = dict(num_jobs=40, tasks_per_job=64, load=0.8, num_workers=256, seed=7)
W = PARITY["num_workers"]
MEGHA_KW = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0)


def _np(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _assert_same(ours: dict, theirs: dict):
    assert ours.keys() == theirs.keys()
    for name, want in theirs.items():
        got = ours[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nan_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        same = a[k] == b[k] or (
            isinstance(a[k], float) and math.isnan(a[k]) and math.isnan(b[k])
        )
        assert same, (k, a[k], b[k])


# ---------------------------------------------------------------------------
# runtime helpers, bitwise
# ---------------------------------------------------------------------------


def _helper_case(name: str, rng: np.random.Generator):
    """(args for the reference as numpy arrays, port-only kwargs) per helper."""
    T = 50
    fin = rng.uniform(0, 5, T + 1).astype(np.float32)
    fin[rng.random(T + 1) < 0.4] = np.inf
    if name == "slice_rows":
        return (rng.integers(0, 99, (4, 40)).astype(np.int32),
                rng.integers(0, 30, 4).astype(np.int32), 10)
    if name == "sorted_fifo":
        return (rng.random((4, 33)) < 0.5, 33)
    if name == "finish_pad":
        return (fin[:T],)
    if name == "window_launched":
        return (fin, rng.integers(0, T + 1, (4, 12)).astype(np.int32), T)
    if name == "launched_lead":
        return (np.cumsum(rng.random((4, 20)) < 0.8, axis=1) < 6,)
    if name == "select_from_window":
        queued = rng.random((4, 16)) < 0.5
        fifo = np.asarray(jax_rt.sorted_fifo(jnp.asarray(queued), 16))
        ranks = np.asarray(jax_rt.ref.match_ranks_batched_ref(
            jnp.asarray(rng.random((4, 24)) < 0.5), jnp.asarray(queued.sum(1), jnp.int32)))
        return (ranks, fifo, rng.integers(0, T, (4, 16)).astype(np.int32), T)
    if name == "apply_launch":
        launch = rng.random(32) < 0.5
        pick = np.where(launch, rng.permutation(T)[:32], T).astype(np.int32)
        return (launch, pick, np.float32(1.25), np.append(fin[:T], 0).astype(np.float32),
                fin[:T].copy(), rng.uniform(-1, 3, 32).astype(np.float32),
                rng.integers(0, T + 1, 32).astype(np.int32), T)
    if name == "completion_masks":
        wf = rng.uniform(0, 2, 64).astype(np.float32)
        wf[:5] = -np.inf
        return (wf, np.float32(1.0), 0.05)
    if name == "job_delays_from_state":
        tasks = jax_export_workload(jax_synth.yahoo_like_trace(
            num_jobs=12, total_tasks=T, num_workers=16, seed=1))
        tf = fin[:T].copy()
        return (tf, np.float32(2.5), tasks)
    raise KeyError(name)


HELPERS = [
    "slice_rows", "sorted_fifo", "finish_pad", "window_launched",
    "launched_lead", "select_from_window", "apply_launch",
    "completion_masks", "job_delays_from_state",
]


@pytest.mark.parametrize("name", HELPERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_runtime_helper_matches_reference(name, seed):
    args = _helper_case(name, np.random.default_rng(seed))
    jax_args, our_args = [], []
    for a in args:
        if isinstance(a, (np.ndarray, np.generic)):
            jax_args.append(jnp.asarray(a))
            our_args.append(_t(a))
        elif dataclasses.is_dataclass(a):
            jax_args.append(a)
            our_args.append(convert.tasks_from_numpy(_np(a), "cpu"))
        else:
            jax_args.append(a)
            our_args.append(a)
    want = getattr(jax_rt, name)(*jax_args)
    got = getattr(rt, name)(*our_args)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_slice_rows_refuses_rows_narrower_than_the_window():
    with pytest.raises(ValueError):
        rt.slice_rows(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 5)


# ---------------------------------------------------------------------------
# round steps, bitwise, on tests/test_simx.py's `small` config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    wl = jax_synth.synthetic_trace(
        num_jobs=10, tasks_per_job=32, load=0.8, num_workers=64, seed=3)
    tasks = jax_export_workload(wl)
    kw = dict(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)
    jcfg, cfg = JaxSimxConfig(**kw), SimxConfig(**kw)
    rounds = jax_engine.estimate_rounds(jcfg, tasks)
    return jcfg, cfg, tasks, convert.tasks_from_numpy(_np(tasks), "cpu"), rounds


def test_estimate_rounds_matches_reference_on_small(small):
    jcfg, cfg, jtasks, tasks, rounds = small
    assert engine.estimate_rounds(cfg, tasks) == rounds


@pytest.mark.parametrize("seed", [0, 5])
def test_megha_step_matches_reference(small, seed):
    jcfg, cfg, jtasks, tasks, rounds = small
    orders = jax_megha.gm_orders(jax.random.PRNGKey(seed), jcfg)
    jstep = jax_megha.make_megha_step(jcfg, jtasks, orders)
    want = jax.jit(lambda s: jax_rt.scan_rounds(jstep, s, rounds))(
        jax_init_megha_state(jcfg, jtasks.num_tasks))
    step = megha.make_megha_step(cfg, tasks, _t(orders))
    got = rt.scan_rounds(step, init_megha_state(cfg, tasks.num_tasks, "cpu"), rounds)
    assert isinstance(got, MeghaState)
    _assert_same(convert.state_to_numpy(got), _np(want))
    assert 0 < step.borrow_rounds < rounds
    assert int(got.inconsistencies) > 0 and int(got.repartitions) > 0


def test_oracle_step_matches_reference(small):
    jcfg, cfg, jtasks, tasks, rounds = small
    jstep = jax_oracle.make_oracle_step(jcfg, jtasks)
    want = jax.jit(lambda s: jax_rt.scan_rounds(jstep, s, rounds))(
        jax_init_oracle_state(jcfg, jtasks.num_tasks))
    got = rt.scan_rounds(
        oracle.make_oracle_step(cfg, tasks), init_oracle_state(cfg, tasks.num_tasks, "cpu"),
        rounds)
    assert isinstance(got, OracleState)
    _assert_same(convert.state_to_numpy(got), _np(want))


def test_convert_round_trips_a_state(small):
    jcfg, cfg, jtasks, tasks, rounds = small
    state = jax_init_megha_state(jcfg, jtasks.num_tasks)
    ours = convert.state_from_numpy(MeghaState, _np(state), "cpu")
    _assert_same(convert.state_to_numpy(ours), _np(state))
    _assert_same(convert.state_to_numpy(tasks), _np(jtasks))


def test_gm_orders_are_per_gm_permutations_internal_first(small):
    jcfg, cfg, *_ = small
    orders = megha.gm_orders(torch.Generator().manual_seed(0), cfg)
    assert orders.dtype == torch.int32 and orders.shape == (cfg.num_gms, cfg.num_workers)
    part = cfg.partition_gms("cpu")
    wi = cfg.num_workers // cfg.num_gms
    for g in range(cfg.num_gms):
        row = orders[g]
        assert sorted(row.tolist()) == list(range(cfg.num_workers))
        assert (part[row[:wi].long()] == g).all() and (part[row[wi:].long()] != g).all()
    again = megha.gm_orders(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(orders, again)


# ---------------------------------------------------------------------------
# the whole path: run_simulation(..., backend="simx") on the parity trace
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity_runs():
    """Reference and port simx runs of megha and the oracle on PARITY, the
    port fed the reference's GM orders (drawn from PRNGKey(seed=0))."""
    wl_j = jax_synth.synthetic_trace(**PARITY)
    wl = synth.synthetic_trace(**PARITY)
    jcfg = JaxSimxConfig(num_workers=W, dt=0.01, **MEGHA_KW)
    orders = _t(jax_megha.gm_orders(jax.random.PRNGKey(0), jcfg))
    out = {}
    for name, kw in (("megha", dict(MEGHA_KW, orders=orders)), ("oracle", {})):
        jkw = {k: v for k, v in kw.items() if k != "orders"}
        ref_run = jax_simulate_workload(name, wl_j, W, dt=0.01, seed=0, **jkw)
        run = simulate_workload(name, wl, W, dt=0.01, seed=0, device="cpu", **kw)
        metrics = run_simulation(
            name, wl, W, backend="simx", dt=0.01, seed=0, device="cpu", **kw)
        out[name] = (ref_run, run, metrics)
    return out


@pytest.mark.parametrize("name", ["megha", "oracle"])
def test_parity_trace_final_state_matches_reference(parity_runs, name):
    ref_run, run, _ = parity_runs[name]
    _assert_same(convert.state_to_numpy(run.state), _np(ref_run.state))
    assert run.tasks_completed == ref_run.tasks_completed == run.tasks.num_tasks
    assert run.end_time == ref_run.end_time


@pytest.mark.parametrize("name", ["megha", "oracle"])
def test_parity_trace_delays_and_summary_match_reference(parity_runs, name):
    ref_run, run, metrics = parity_runs[name]
    np.testing.assert_array_equal(run.job_delays(), ref_run.job_delays())
    np.testing.assert_array_equal(run.job_finish_times(), ref_run.job_finish_times())
    want = ref_run.to_run_metrics().summary()
    _nan_equal(run.to_run_metrics().summary(), want)
    _nan_equal(metrics.summary(), want)


def test_parity_trace_megha_tracks_event_backend(parity_runs):
    """The reference's own events-vs-simx tolerance (test_event_simx_parity)."""
    _, _, sx = parity_runs["megha"]
    ev = jax_run_simulation(
        "megha", jax_synth.synthetic_trace(**PARITY), num_workers=W, seed=0, **MEGHA_KW)
    done = sum(1 for t in sx.tasks if t.finish_time == t.finish_time)
    assert done == PARITY["num_jobs"] * PARITY["tasks_per_job"]
    d_ev, d_sx = ev.job_delays(), sx.job_delays()
    assert percentile(d_sx, 50) == pytest.approx(percentile(d_ev, 50), rel=0.15)
    assert percentile(d_sx, 95) == pytest.approx(percentile(d_ev, 95), rel=0.15)
    assert ev.inconsistencies > 0 and sx.inconsistencies > 0
    assert ev.repartitions > 0 and sx.repartitions > 0


def test_parity_trace_oracle_lower_bounds_megha(parity_runs):
    m = parity_runs["megha"][1].job_delays()
    o = parity_runs["oracle"][1].job_delays()
    for p in (50, 95):
        assert np.percentile(o, p) <= np.percentile(m, p) + 1e-6


@pytest.mark.parametrize(
    "trace",
    ["parity", "small", "yahoo_like", "google_like"],
)
def test_estimate_rounds_matches_reference(trace):
    make = {
        "parity": lambda m: m.synthetic_trace(**PARITY),
        "small": lambda m: m.synthetic_trace(
            num_jobs=10, tasks_per_job=32, load=0.8, num_workers=64, seed=3),
        "yahoo_like": lambda m: m.yahoo_like_trace(
            num_jobs=300, total_tasks=12000, num_workers=1000, seed=2),
        "google_like": lambda m: m.google_like_trace(
            num_jobs=200, total_tasks=6200, num_workers=1000, seed=3),
    }[trace]
    jtasks = jax_export_workload(make(jax_synth))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    for dt in (0.01, 0.05):
        kw = dict(num_workers=256, dt=dt, heartbeat_interval=1.0)
        assert engine.estimate_rounds(SimxConfig(**kw), tasks) == \
            jax_engine.estimate_rounds(JaxSimxConfig(**kw), jtasks)


def test_until_cap_runs_the_partial_chunk_like_the_reference():
    """A budget that is not a multiple of the chunk stops exactly there, as
    the reference's jitted tail does (state bitwise)."""
    kw = dict(num_jobs=8, tasks_per_job=16, task_duration=0.1, load=0.5,
              num_workers=64, seed=1)
    jcfg = JaxSimxConfig(num_workers=64, num_gms=8, num_lms=8, dt=0.05)
    orders = jax_megha.gm_orders(jax.random.PRNGKey(0), jcfg)
    ref_run = jax_simulate_workload(
        "megha", jax_synth.synthetic_trace(**kw), 64, until=0.3, dt=0.05, chunk=4)
    run = simulate_workload(
        "megha", synth.synthetic_trace(**kw), 64, until=0.3, dt=0.05, chunk=4,
        orders=_t(orders), device="cpu")
    assert int(run.state.rnd) == int(ref_run.state.rnd) == 6
    _assert_same(convert.state_to_numpy(run.state), _np(ref_run.state))
    assert run.tasks_completed < run.tasks.num_tasks


def test_plain_match_path_equals_kernel_wrapper_path(small):
    """``use_kernel=False`` (the plain version everywhere) and the default
    wrapper path give the same run; on the CPU both are the plain version,
    which is what the card run is held against."""
    wl = synth.synthetic_trace(num_jobs=10, tasks_per_job=32, load=0.8, num_workers=64, seed=3)
    kw = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, dt=0.02, device="cpu")
    a = simulate_workload("megha", wl, 64, **kw)
    b = simulate_workload("megha", wl, 64, use_kernel=False, **kw)
    _assert_same(convert.state_to_numpy(a.state), convert.state_to_numpy(b.state))
    assert a.borrow_rounds == b.borrow_rounds > 0
    assert a.tasks_completed == a.tasks.num_tasks


def test_entry_points_refuse_what_is_not_ported(monkeypatch):
    wl = synth.synthetic_trace(num_jobs=2, tasks_per_job=4, num_workers=64, seed=0)
    with pytest.raises(NotImplementedError, match="event backend"):
        run_simulation("sparrow", wl, 64)
    with pytest.raises(NotImplementedError, match="fault"):
        run_simulation("megha", wl, 64, backend="simx", faults=object(), device="cpu")
    with pytest.raises(ValueError, match="implements"):
        simulate_workload("sparrow", wl, 64, device="cpu")
    with pytest.raises(NotImplementedError):
        rt.compose_step(SimxConfig(num_workers=64), None, lambda *a: {}, telemetry=True)
    # the default device is the card; without one the entry point raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation("oracle", wl, 64, backend="simx")
