"""The port's sharded executors (``repro_torch.simx.shard``) against its
serial entry points and against the reference's ``repro.simx.shard``, on the
CPU.

The reference's own configuration (``tests/test_simx_shard.py``): a
15-point Fig. 2 grid (5 loads x 3 seeds, indivisible by 8), a 3 x 2 Fig. 4
grid, and the small streaming window.  The port's mesh here is the one CPU
(``sweep_mesh(device="cpu")``) and the CPU named 8 or 2 times, so the pad
/ split / gather path runs as the reference's CI runs it on 8 forced CPU
devices.  Every sharded grid and every steady-state lane is bitwise the
port's serial entry point, and agrees with the reference's sharded executors
(run on its one CPU device) within rtol 1e-5, with exact counters.  The
port is fed the reference's draws (per seed for the grids, megha's one GM
order for the lanes); sparrow's and eagle's streamed windows draw their
probe targets with the same numpy calls in both packages.  On top: the
P² sketch's lane axis, ``pad_batch``, the mesh's validation and the
refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import megha as jax_megha
from repro.simx import shard as jax_shard
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import stream as jax_stream
from repro.simx import sweep as jax_sweep
from repro.workload import synth as jax_synth
from repro_torch.kernels import p2
from repro_torch.simx import runtime, shard, stream, sweep
from repro_torch.simx import telemetry as tlm
from repro_torch.workload import synth

RULES = ("megha", "sparrow", "eagle", "pigeon", "oracle")

#: the reference test's grids: 5 loads x 3 seeds = 15 points, which an
#: 8-entry mesh pads to 16; 3 fractions x 2 seeds
FIG2 = dict(loads=(0.35, 0.55, 0.7, 0.85, 0.95), num_seeds=3, num_workers=64,
            num_jobs=6, tasks_per_job=8, dt=0.05, num_gms=2, num_lms=2)
FIG4 = dict(fractions=(0.0, 0.05, 0.1), num_seeds=2, num_workers=64, num_jobs=6,
            tasks_per_job=8, dt=0.05, num_gms=2, num_lms=2)
#: the reference test's streaming window and workers; three lanes of
#: different loads and lengths, so they drain at different refills, on a
#: 2-entry mesh, so lane 0 is repeated once as a pad
STEADY = dict(window_jobs=16, window_tasks=128, rounds_per_refill=16, num_gms=2, num_lms=2)
STEADY_W = 64
LANES = ((0.5, 24), (0.9, 12), (0.7, 40))
MESHES = {"one": lambda: shard.sweep_mesh(device="cpu"),
          "cpu_x8": lambda: shard.Mesh(("cpu",) * 8)}
INT_KEYS = ("jobs_done", "tasks_done", "lost", "messages", "probes", "inconsistencies",
            "res_overflow", "probe_lag")
FLOAT_KEYS = ("p50", "p95", "mean", "mean_util", "inconsistency_rate")
COUNTERS = ("jobs_admitted", "jobs_completed", "tasks_admitted", "tasks_completed",
            "lost", "messages", "probes", "rounds", "end_time")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: a round is a few hundred small ops, which
    threads do not speed up, and parallel test workers contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


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


def _ref_draws(name, jplan):
    per_seed = [_ref_point_draws(name, jplan.cfg, jplan.tasks, s) for s in jplan.seeds]
    return None if per_seed[0] is None else {
        k: torch.stack([d[k] for d in per_seed]) for k in per_seed[0]}


def _assert_bitwise(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        g = got[k]
        g, v = (np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g),
                np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v))
        assert g.dtype == v.dtype and g.shape == v.shape, f"{what}:{k}"
        assert np.array_equal(g, v, equal_nan=True), f"{what}:{k}"


def _assert_close_to_reference(got: dict, ref: dict, what: str):
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=f"{what}:{k}")
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=f"{what}:{k}")


@functools.lru_cache(maxsize=None)
def _fig2(rule):
    """The reference's sharded grid, the port's plan fed the reference's
    draws, and the port's serial grid (cached per rule)."""
    jplan = jax_sweep.fig2_plan(rule, **FIG2)
    ref = jax_shard.sharded_sweep_grid(
        jplan.name, jplan.cfg, jplan.tasks, jplan.submit_grid, jplan.job_submit_grid,
        jplan.seeds, jplan.num_rounds, match_fn=jplan.match_fn, pick_fn=jplan.pick_fn,
        mesh=jax_shard.sweep_mesh())
    plan = sweep.fig2_plan(rule, draws=_ref_draws(rule, jplan), device="cpu", **FIG2)
    serial = sweep.sweep_grid(plan.name, plan.cfg, plan.tasks, plan.submit_grid,
                              plan.job_submit_grid, plan.seeds, plan.num_rounds,
                              draws=plan.draws)
    return ref, plan, serial


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rule", RULES)
def test_sharded_fig2_grid_is_bitwise_serial_and_matches_reference(rule, mesh):
    ref, plan, serial = _fig2(rule)
    got = shard.sharded_sweep_grid(
        plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid, plan.seeds,
        plan.num_rounds, draws=plan.draws, mesh=MESHES[mesh]())
    L, S = len(FIG2["loads"]), FIG2["num_seeds"]
    assert got["p50"].shape == (L, S)
    _assert_bitwise(got, serial, f"{rule}/{mesh}")
    _assert_close_to_reference(got, ref, rule)


@functools.lru_cache(maxsize=None)
def _fig4(rule, num_seeds=FIG4["num_seeds"]):
    spec = dict(FIG4, num_seeds=num_seeds)
    jplan = jax_sweep.fig4_plan(rule, **spec)
    ref = jax_shard.sharded_fig4_sweep(rule, mesh=jax_shard.sweep_mesh(), **spec)
    draws = _ref_draws(rule, jplan)
    serial = sweep.fig4_sweep(rule, draws=draws, device="cpu", **spec)
    return ref, draws, serial


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rule", RULES)
def test_sharded_fig4_grid_is_bitwise_serial_and_matches_reference(rule, mesh):
    ref, draws, serial = _fig4(rule)
    m = MESHES[mesh]()
    got = shard.sharded_fig4_sweep(rule, mesh=m, draws=draws, **FIG4)
    assert int(got["n_devices"]) == len(m)
    _assert_bitwise({k: v for k, v in got.items() if k != "n_devices"}, serial,
                    f"{rule}/{mesh}")
    _assert_close_to_reference(got, ref, rule)
    assert int(ref["n_devices"]) == 1


def test_fault_grid_is_seed_sensitive():
    """Distinct per-point draws each give their own numbers through the
    sharded executor, and the serial grid itself varies across seeds, so
    a collapse onto one point's draws could not pass unseen (the
    reference's regression pin for its shard_map lowering)."""
    ref, draws, serial = _fig4("megha", num_seeds=4)
    got = shard.sharded_fig4_sweep("megha", mesh=MESHES["cpu_x8"](), draws=draws,
                                   **dict(FIG4, num_seeds=4))
    for key in ("p50", "p95"):
        assert np.array_equal(got[key], serial[key], equal_nan=True)
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=1e-5, equal_nan=True)
    assert np.any(np.ptp(serial["p95"], axis=1) > 0), "the seeds must differ somewhere"


def test_fig2_uneven_grid_shapes_and_the_runner_runs_again():
    """15 points on 8 entries: the outputs keep the [L, S] shape with no
    pad rows, and the runner gives the same numbers when called again."""
    _, plan, serial = _fig2("megha")
    run = shard.sharded_grid_program(
        plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid, plan.seeds,
        plan.num_rounds, draws=plan.draws, mesh=MESHES["cpu_x8"]())
    first, again = run(), run()
    assert first["p50"].shape == (5, 3)
    assert torch.all(torch.isfinite(first["mean_util"]))
    _assert_bitwise(again, first, "again")
    _assert_bitwise(first, serial, "serial")


def test_sharded_fig2_sweep_entry_point():
    """``sharded_fig2_sweep`` takes ``fig2_sweep``'s keywords and returns
    its numpy results, plus ``n_devices``."""
    _, plan, _ = _fig2("pigeon")
    want = sweep.fig2_sweep("pigeon", device="cpu", **FIG2)
    got = shard.sharded_fig2_sweep("pigeon", mesh=shard.Mesh(("cpu",) * 4), **FIG2)
    assert int(got.pop("n_devices")) == 4
    _assert_bitwise(got, want, "pigeon")


def test_sweep_mesh_validation():
    mesh = shard.sweep_mesh(device="cpu")
    assert len(mesh) == 1 and mesh[0] == torch.device("cpu")
    assert shard.sweep_mesh(1, device="cpu") == mesh
    for n in (0, 2):
        with pytest.raises(ValueError, match="offers 1 device"):
            shard.sweep_mesh(n, device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        shard.Mesh(())


def test_pad_batch():
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": torch.arange(10, dtype=torch.int32).reshape(5, 2)}
    padded, n = shard.pad_batch(tree, 5, 4)
    assert n == 8
    assert padded["a"].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    assert padded["b"][5:].tolist() == [[8, 9]] * 3
    same, n_same = shard.pad_batch(tree, 5, 5)
    assert n_same == 5 and same is tree
    with pytest.raises(ValueError):
        shard.pad_batch(tree, 0, 4)


def test_unknown_rule_raises():
    _, plan, _ = _fig2("oracle")
    with pytest.raises(ValueError, match="simx backend implements"):
        shard.sharded_sweep_grid("nosuchrule", plan.cfg, plan.tasks, plan.submit_grid,
                                 plan.job_submit_grid, plan.seeds, plan.num_rounds)
    with pytest.raises(ValueError, match="simx backend implements"):
        shard.sharded_steady_state("nosuchrule", [], STEADY_W, device="cpu")


def test_sharded_executors_default_to_the_card(monkeypatch):
    """``device=None`` is the card: without one, every sharded executor
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.sharded_steady_state("megha", [_arrivals(synth, 0.5, 24)], STEADY_W, **STEADY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.sharded_fig2_sweep("megha", **FIG2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.sharded_fig4_sweep("megha", **FIG4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.sweep_mesh()


# ---------------------------------------------------------------------------
# the lane-batched steady state
# ---------------------------------------------------------------------------


def _arrivals(pkg, load, num_jobs):
    # fixed_job_factory(8, 1.0): 8 task-seconds a job
    return pkg.PoissonArrivals(rate=load * STEADY_W / 8.0,
                               job_factory=pkg.fixed_job_factory(8, 1.0), seed=7,
                               num_jobs=num_jobs)


@functools.lru_cache(maxsize=None)
def _ref_orders():
    jcfg = jax_stream.stream_config("megha", STEADY_W, window_tasks=STEADY["window_tasks"],
                                    num_gms=STEADY["num_gms"], num_lms=STEADY["num_lms"])
    return _t(jax_megha.gm_orders(jax.random.PRNGKey(0), jcfg))


def _assert_runs_bitwise(got, want, what: str):
    assert np.array_equal(got.delays, want.delays), what
    assert got.refills == want.refills, what
    assert set(got.series) == set(want.series)
    for k in want.series:
        assert np.array_equal(got.series[k], want.series[k], equal_nan=True), (what, k)
    assert np.array_equal(got.quantile_estimates, want.quantile_estimates, equal_nan=True)
    for f in COUNTERS + ("state_bytes", "borrow_rounds"):
        assert getattr(got, f) == getattr(want, f), (what, f)


@pytest.mark.parametrize("rule", RULES)
def test_steady_state_lanes_are_bitwise_serial_and_match_reference(rule):
    """Three lanes on a 2-entry mesh (lane 0 repeated as the pad), which
    drain at different refills: each lane is bitwise the port's serial
    run, and matches the reference's sharded lane (sketch estimates and
    sorted delays at rtol 1e-5, counters and rounds exact)."""
    kw = dict(STEADY, orders=_ref_orders()) if rule == "megha" else dict(STEADY)
    serial = [stream.run_steady_state(rule, _arrivals(synth, ld, n), STEADY_W, device="cpu",
                                      **kw) for ld, n in LANES]
    lanes = shard.sharded_steady_state(
        rule, [_arrivals(synth, ld, n) for ld, n in LANES], STEADY_W,
        mesh=shard.Mesh(("cpu",) * 2), **kw)
    ref = jax_shard.sharded_steady_state(
        rule, [_arrivals(jax_synth, ld, n) for ld, n in LANES], STEADY_W,
        mesh=jax_shard.sweep_mesh(1), **STEADY)
    assert len(lanes) == len(serial) == len(ref) == len(LANES)
    assert len({run.rounds for run in lanes}) == len(LANES), "lanes drain at different refills"
    for i, (got, want, theirs) in enumerate(zip(lanes, serial, ref)):
        _assert_runs_bitwise(got, want, f"{rule} lane {i}")
        for f in COUNTERS:
            assert getattr(got, f) == getattr(theirs, f), (rule, i, f)
        np.testing.assert_allclose(got.quantile_estimates, np.asarray(theirs.quantile_estimates),
                                   rtol=1e-5, equal_nan=True)
        np.testing.assert_allclose(np.sort(got.delays), np.sort(theirs.delays), rtol=1e-5)


def test_steady_state_one_lane_on_one_entry_is_the_serial_run():
    """One lane on the one-CPU mesh: no pad, and the serial run bitwise,
    its borrow rounds included (the lane's own, from the batched step)."""
    kw = dict(STEADY, orders=_ref_orders())
    want = stream.run_steady_state("megha", _arrivals(synth, 0.9, 24), STEADY_W,
                                   device="cpu", **kw)
    (got,) = shard.sharded_steady_state("megha", [_arrivals(synth, 0.9, 24)], STEADY_W,
                                        device="cpu", **kw)
    _assert_runs_bitwise(got, want, "megha")
    assert got.borrow_rounds > 0


def test_steady_state_refusals():
    with pytest.raises(ValueError, match="at least one lane"):
        shard.sharded_steady_state("megha", [], STEADY_W, device="cpu", **STEADY)
    with pytest.raises(ValueError, match="pass no draws"):
        shard.sharded_steady_state("pigeon", [_arrivals(synth, 0.5, 4)], STEADY_W,
                                   device="cpu", orders=_ref_orders(), **STEADY)
    # telemetry and provenance stay on the serial path, as in the reference
    for flag in (dict(telemetry=True), dict(provenance=True)):
        with pytest.raises(ValueError, match="one lane on one device"):
            shard.sharded_steady_state("sparrow", [_arrivals(synth, 0.5, 4)] * 2, STEADY_W,
                                       device="cpu", **flag, **STEADY)


# ---------------------------------------------------------------------------
# the P² sketch's lane axis
# ---------------------------------------------------------------------------


def _lane_values(lanes: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.lognormal(0.0, 0.7, (lanes, n)).astype(np.float32))
    mask = torch.from_numpy(rng.random((lanes, n)) < 0.8)
    if lanes > 1:
        mask[1] = False          # a lane with no valid value
    return vals, mask


@pytest.mark.parametrize("lanes,n", [(1, 40), (4, 193), (3, 7)])
def test_lane_batched_absorb_is_bitwise_each_lane_alone(lanes, n):
    """The plain absorb of a lane-batched sketch (and the kernel wrapper's
    CPU path) is bitwise each lane's 1-D absorb, over two calls; a lane
    with no valid value stays fresh; quantiles per lane likewise."""
    vals, mask = _lane_values(lanes, n, seed=lanes * 100 + n)
    sk = tlm.sketch_init(device="cpu", lanes=lanes)
    assert sk.q.shape == (lanes, 4, 5) and sk.count.shape == (lanes,)
    alone = [tlm.sketch_init(device="cpu") for _ in range(lanes)]
    half = n // 2
    for part in (slice(0, half), slice(half, n)):
        sk_plain = tlm.sketch_absorb(sk, vals[:, part], mask[:, part])
        sk = p2.p2_absorb(sk, vals[:, part].contiguous(), mask[:, part].contiguous())
        alone = [tlm.sketch_absorb(a, vals[i, part], mask[i, part])
                 for i, a in enumerate(alone)]
        for f in ("q", "n", "npd", "dn", "buf", "count"):
            assert torch.equal(getattr(sk, f), getattr(sk_plain, f)), f
            assert torch.equal(getattr(sk, f), torch.stack([getattr(a, f) for a in alone])), f
    assert sk.count.tolist() == mask.sum(dim=1).tolist()
    q = tlm.sketch_quantiles(sk)
    assert q.shape == (lanes, 4)
    for i, a in enumerate(alone):
        want = tlm.sketch_quantiles(a).numpy()
        assert np.array_equal(q[i].numpy(), want, equal_nan=True)
        lane = runtime.tree_map(lambda x: x[i], sk)
        assert np.array_equal(tlm.sketch_quantiles(lane).numpy(), want, equal_nan=True)
    if lanes > 1:
        assert bool(torch.isnan(q[1]).all())


def test_p2_absorb_checks_the_lane_shapes():
    sk = tlm.sketch_init(device="cpu", lanes=3)
    vals, mask = _lane_values(3, 10, seed=1)
    with pytest.raises(ValueError, match="lanes"):
        p2.p2_absorb(sk, vals[0], mask[0])
    with pytest.raises(ValueError, match="lanes"):
        p2.p2_absorb(sk, vals[:2], mask[:2])
    with pytest.raises(ValueError, match="lanes"):
        p2.p2_absorb(tlm.sketch_init(device="cpu"), vals, mask)
