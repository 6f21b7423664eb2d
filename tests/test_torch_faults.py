"""The port's fault subsystem (``repro_torch.simx.faults``, the runtime's
fault stage and each rule's fault branch) against the JAX reference on the
CPU.

Every rule's final state is held bitwise against ``repro.simx`` under four
schedules: the empty one (also bitwise the fault-free run), the
reference's crash wave (32 of 128 workers down over ``[2, 5)``), instant
restarts, and, for megha, GM down-windows with a recovery and a heartbeat
delay.  The reference runs with its default jnp match and is fed nothing
but its own seed; the port gets the reference's draws of that seed.  The
schedules are built by each package from the same plan or numpy seed and
compared bit for bit.  Then the plan's validation errors, and
``run_simulation(faults=)`` on both backends: the event backend's megha
record for record under the reference's ``PARITY_PLAN``."""

import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import RunMetrics as JaxRunMetrics
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.simx import FaultPlan as JaxFaultPlan
from repro.simx import GmOutage as JaxGmOutage
from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import WorkerFailure as JaxWorkerFailure
from repro.simx import engine as jax_engine
from repro.simx import export_workload as jax_export_workload
from repro.simx import faults as jax_faults
from repro.simx import megha as jax_megha
from repro.simx import runtime as jax_rt
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.core.events import EventLoop
from repro_torch.core.megha import Megha, MeghaConfig
from repro_torch.core.metrics import RunMetrics
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import (
    FaultPlan,
    FaultSchedule,
    GmOutage,
    SimxConfig,
    WorkerFailure,
    convert,
    empty_schedule,
    fault_grid_schedule,
    faults,
    is_empty,
    simulate_workload,
)
from repro_torch.simx import runtime as rt
from repro_torch.workload import synth, traces

RULES = ["megha", "sparrow", "eagle", "pigeon", "oracle"]
#: the mixed trace's config: 128 workers on a 4 x 4 GM x LM grid
CFG = dict(num_workers=128, num_gms=4, num_lms=4, dt=0.05, heartbeat_interval=1.0)
SEED = 5
#: rounds each parity run takes: 16 s, past the crash wave's recovery at 5 s
ROUNDS = 320
#: the reference's events-vs-simx parity plan (tests/test_simx_faults.py)
PARITY_PLAN = dict(
    worker_failures=((3, 4.0), (50, 5.5), (97, 7.0), (200, 8.5)),
    gm_outages=((1, 0.2, 0.8),),
)
PARITY = dict(num_jobs=40, tasks_per_job=64, load=0.8, num_workers=256, seed=7)


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


def _plans(m):
    """The four plans, built with module ``m``'s plan classes."""
    kill = np.random.default_rng(0).permutation(128)
    return {
        "empty": None,
        # the reference's crash wave: 25 % of the DC down over [2, 5)
        "crash_wave": m.FaultPlan(worker_failures=tuple(
            m.WorkerFailure(int(w), 2.0, 5.0) for w in kill[:32])),
        # instant restarts spread over the run (the event backend's mode)
        "restart": m.FaultPlan(worker_failures=tuple(
            m.WorkerFailure(int(w), 1.0 + 0.37 * i) for i, w in enumerate(kill[32:56]))),
        # megha: two GM down-windows (one overlapping a worker crash), a
        # recovery each, and a heartbeat delay of 0.5 s (10 rounds)
        "gm_outage": m.FaultPlan(
            worker_failures=tuple(m.WorkerFailure(int(w), 1.5, 3.0) for w in kill[:8]),
            gm_outages=(m.GmOutage(1, 1.0, 2.5), m.GmOutage(2, 2.0, 4.0)),
            heartbeat_delay=0.5),
    }


CASES = [(n, p) for n in RULES for p in ("empty", "crash_wave", "restart")] + [
    ("megha", "gm_outage")]


def _mixed(m):
    """Long + short jobs on 128 workers (eagle's SSS and central paths,
    pigeon's low queue): 16 jobs, every fourth 8 tasks of 12 s, the rest
    32 tasks of 1 s; module ``m``'s ``Job`` / ``Workload``."""
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
    jcfg, cfg = JaxSimxConfig(**CFG), SimxConfig(**CFG)
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    _assert_same(convert.state_to_numpy(tasks), _np(jtasks))
    return dict(jtasks=jtasks, jcfg=jcfg, cfg=cfg, tasks=tasks, cache={},
                jplans=_plans(jax_faults), plans=_plans(faults))


def _schedules(g, plan: str):
    """(reference schedule, port schedule) of a plan on the mixed config."""
    if plan == "empty":
        return jax_faults.empty_schedule(128, 4), empty_schedule(128, 4)
    return (g["jplans"][plan].to_schedule(128, 4, CFG["dt"]),
            g["plans"][plan].to_schedule(128, 4, CFG["dt"]))


def _port_run(g, name, plan):
    key = (name, plan)
    if key not in g["cache"]:
        fs = None if plan is None else _schedules(g, plan)[1]
        draws = _ref_draws(name, g["jcfg"], g["jtasks"], SEED)
        g["cache"][key] = rt.simulate_fixed(name, g["cfg"], g["tasks"], draws, ROUNDS,
                                            faults=fs)
    return g["cache"][key]


@pytest.mark.parametrize("name,plan", CASES)
def test_final_state_bitwise_reference_under_faults(mixed, name, plan):
    g = mixed
    jfs, fs = _schedules(g, plan)
    np.testing.assert_array_equal(fs.worker_up.numpy(), np.asarray(jfs.worker_up))
    want = jax_rt.simulate_fixed(name, g["jcfg"], g["jtasks"], SEED, ROUNDS, faults=jfs)
    got = _port_run(g, name, plan)
    _assert_same(convert.state_to_numpy(got), _np(want))
    lost = int(got.lost)
    if plan == "empty":
        assert lost == 0
        # the empty schedule is bitwise the fault-free run
        _assert_same(convert.state_to_numpy(got),
                     convert.state_to_numpy(_port_run(g, name, None)))
    else:
        assert lost > 0
        assert not torch.equal(got.task_finish, _port_run(g, name, None).task_finish)


def test_crash_wave_reruns_lost_tasks_to_completion(mixed):
    """The crash wave run to completion on pigeon (the rule with no task
    migration): every task finishes, the lost ones re-run."""
    g = mixed
    rounds = jax_engine.estimate_rounds(g["jcfg"], g["jtasks"]) + int(6.0 / CFG["dt"])
    fs = _schedules(g, "crash_wave")[1]
    st = rt.simulate_fixed("pigeon", g["cfg"], g["tasks"], 0, rounds, faults=fs)
    assert int(st.lost) > 0 and bool(torch.all(st.task_finish <= st.t))


# ---------------------------------------------------------------------------
# schedules and plans
# ---------------------------------------------------------------------------


def _schedule_np(fs) -> dict:
    return {f.name: np.asarray(getattr(fs, f.name)) for f in dataclasses.fields(fs)}


@pytest.mark.parametrize("kw", [
    dict(fractions=(0.0, 0.05, 0.1, 0.2), fail_time=6.2419, outage=5.0, gm_outages=2,
         seed=0),
    dict(fractions=(0.0, 0.25, 0.5), fail_time=1.3, outage=0.7, heartbeat_delay=0.125,
         dt=0.05, seed=3),
])
def test_fault_grid_schedule_matches_reference(kw):
    for workers, gms in ((1000, 8), (49_984, 8), (64, 3)):
        want = _schedule_np(jax_faults.fault_grid_schedule(workers, gms, **kw))
        got = fault_grid_schedule(workers, gms, **kw)
        assert isinstance(got, FaultSchedule) and got.batch == len(kw["fractions"])
        _assert_same(_schedule_np(got), want)


def test_fault_plan_to_schedule_matches_reference():
    for m_plan, j_plan in zip(_plans(faults).values(), _plans(jax_faults).values()):
        if m_plan is None:
            _assert_same(_schedule_np(empty_schedule(128, 4)),
                         _schedule_np(jax_faults.empty_schedule(128, 4)))
            continue
        for dt in (0.05, 0.02, 0.3):
            got = m_plan.to_schedule(128, 4, dt)
            _assert_same(_schedule_np(got), _schedule_np(j_plan.to_schedule(128, 4, dt)))
            assert got.batch is None and is_empty(got) == jax_faults.is_empty(
                j_plan.to_schedule(128, 4, dt))
    assert is_empty(empty_schedule(8, 2))
    assert not is_empty(FaultPlan(heartbeat_delay=0.1).to_schedule(8, 2, 0.05))


def _errors(m) -> list:
    return [
        lambda: m.FaultPlan(worker_failures=(m.WorkerFailure(99, 1.0),)).to_schedule(8, 2, 0.05),
        lambda: m.FaultPlan(worker_failures=(m.WorkerFailure(0, 1.0, 0.5),)).to_schedule(
            8, 2, 0.05),
        lambda: m.FaultPlan(gm_outages=(m.GmOutage(0, 1.0, 0.5),)).to_schedule(8, 2, 0.05),
        lambda: m.FaultPlan(gm_outages=(m.GmOutage(5, 1.0, 1.5),)).to_schedule(8, 2, 0.05),
        lambda: m.fault_grid_schedule(8, 2, (1.0,), fail_time=1.0, outage=1.0),
        lambda: m.FaultPlan(worker_failures=(m.WorkerFailure(5, 1.0),
                                             m.WorkerFailure(5, 3.0))).to_schedule(8, 2, 0.05),
        lambda: m.FaultPlan(gm_outages=(m.GmOutage(1, 1.0, 2.0),
                                        m.GmOutage(1, 3.0, 4.0))).to_schedule(8, 2, 0.05),
    ]


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_errors_are_the_reference_messages():
    got = [_message(fn) for fn in _errors(faults)]
    assert got == [_message(fn) for fn in _errors(jax_faults)]
    for part in ("outside", "before crash", "before failure", "fractions", "duplicate worker",
                 "duplicate GM"):
        assert any(part in msg for msg in got), part


# ---------------------------------------------------------------------------
# the masked transitions on a point axis
# ---------------------------------------------------------------------------


def test_transitions_on_a_point_axis_are_each_point_alone():
    rng = np.random.default_rng(4)
    B, W, G, T = 3, 40, 5, 60
    fs = fault_grid_schedule(W, G, (0.0, 0.3, 0.6), fail_time=1.0, outage=0.5,
                             gm_outages=2, seed=2)
    t = torch.tensor([1.0, 1.02, 1.5], dtype=torch.float32)
    fin = torch.from_numpy(rng.uniform(0, 3, (B, T)).astype(np.float32))
    wf = torch.from_numpy(rng.uniform(0, 3, (B, W)).astype(np.float32))
    wt = torch.from_numpy(rng.permutation(T)[:W].astype(np.int32)).expand(B, W).contiguous()
    batched = faults.apply_worker_faults(fs, t, 0.05, fin, wf, wt, T)
    down = faults.gm_down_mask(fs, t)
    rnd = torch.tensor([3, 7, 11], dtype=torch.int32)
    adopt = faults.gm_adoption(down, rnd)
    for b in range(B):
        one = FaultSchedule(**{f.name: getattr(fs, f.name)[b]
                               for f in dataclasses.fields(fs)})
        alone = faults.apply_worker_faults(one, t[b], 0.05, fin[b], wf[b], wt[b], T)
        for x, y in zip(batched, alone):
            assert torch.equal(x[b], y)
        assert torch.equal(faults.worker_dead(fs, t)[b], faults.worker_dead(one, t[b]))
        assert torch.equal(down[b], faults.gm_down_mask(one, t[b]))
        assert torch.equal(faults.gm_recovered_now(fs, t + 0.5, 0.05)[b],
                           faults.gm_recovered_now(one, t[b] + 0.5, 0.05))
        for x, y in zip(adopt, faults.gm_adoption(down[b], rnd[b])):
            assert torch.equal(x[b], y)
    assert int(batched[3][0]) == 0 and int(batched[3][1]) > 0


@pytest.mark.parametrize("down", [[0, 0, 0, 0, 0], [1, 0, 0, 1, 0], [1, 1, 1, 1, 0],
                                  [1, 1, 1, 1, 1]])
def test_gm_adoption_matches_reference(down):
    d = np.array(down, bool)
    for rnd in (0, 1, 2, 7, 1000):
        want = jax_faults.gm_adoption(jnp.asarray(d), jnp.int32(rnd))
        got = faults.gm_adoption(torch.from_numpy(d), torch.tensor(rnd, dtype=torch.int32))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# run_simulation(faults=) on both backends
# ---------------------------------------------------------------------------


def _parity_plan(m):
    return m.FaultPlan(
        worker_failures=tuple(m.WorkerFailure(w, t) for w, t in PARITY_PLAN["worker_failures"]),
        gm_outages=tuple(m.GmOutage(g, a, b) for g, a, b in PARITY_PLAN["gm_outages"]),
    )


def _records(m) -> tuple:
    return ([dataclasses.astuple(r) for r in m.tasks], [dataclasses.astuple(r) for r in m.jobs],
            m.inconsistencies, m.repartitions, m.messages, m.probes)


def _same_records(a, b) -> bool:
    def same(x, y):
        if isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y):
            return True
        return x == y
    return all(same(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)) and len(a) == len(b)


def test_events_megha_matches_reference_under_the_parity_plan():
    kw = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, seed=0)
    got = run_simulation("megha", synth.synthetic_trace(**PARITY), 256,
                         faults=_parity_plan(faults), **kw)
    want = jax_run_simulation("megha", jax_synth.synthetic_trace(**PARITY), 256,
                              faults=_parity_plan(jax_faults), **kw)
    assert isinstance(got, RunMetrics) and isinstance(want, JaxRunMetrics)
    g, w = _records(got), _records(want)
    assert _same_records(g[0], w[0]) and _same_records(g[1], w[1])
    assert g[2:] == w[2:] and got.inconsistencies > 0
    assert len(got.job_delays()) >= PARITY["num_jobs"]


def test_events_backend_fault_errors_match_reference():
    wl = synth.synthetic_trace(num_jobs=8, tasks_per_job=16, load=0.6, num_workers=64, seed=2)
    jwl = jax_synth.synthetic_trace(num_jobs=8, tasks_per_job=16, load=0.6, num_workers=64,
                                    seed=2)
    plan, jplan = (m.FaultPlan(worker_failures=(m.WorkerFailure(0, 0.5),))
                   for m in (faults, jax_faults))
    m = run_simulation("megha", wl, 64, num_gms=2, num_lms=2, faults=plan)
    assert len(m.job_delays()) == 8
    cases = [
        (dict(scheduler="sparrow", faults=(plan, jplan)), "backend='simx'"),
        (dict(scheduler="eagle", faults=(plan, jplan)), "backend='simx'"),
        (dict(scheduler="pigeon", faults=(plan, jplan)), "backend='simx'"),
        (dict(scheduler="megha", faults=tuple(
            m_.FaultPlan(worker_failures=(m_.WorkerFailure(0, 0.5, 2.0),))
            for m_ in (faults, jax_faults))), "down-window"),
        (dict(scheduler="megha", faults=(empty_schedule(64), jax_faults.empty_schedule(64))),
         "FaultPlan"),
        (dict(scheduler="megha", faults=tuple(
            m_.FaultPlan(worker_failures=(m_.WorkerFailure(9999, 1.0),))
            for m_ in (faults, jax_faults))), "outside"),
        (dict(scheduler="megha", faults=tuple(
            m_.FaultPlan(heartbeat_delay=1.0) for m_ in (faults, jax_faults))),
         "heartbeat_delay"),
    ]
    for case, part in cases:
        ours, theirs = case["faults"]
        kw = dict(num_gms=2, num_lms=2) if case["scheduler"] == "megha" else {}
        with pytest.raises(ValueError, match=part) as e1:
            run_simulation(case["scheduler"], wl, 64, faults=ours, **kw)
        with pytest.raises(ValueError) as e2:
            jax_run_simulation(case["scheduler"], jwl, 64, faults=theirs, **kw)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="covers"):
        run_simulation("sparrow", wl, 64, backend="simx", faults=empty_schedule(32),
                       device="cpu")
    with pytest.raises(ValueError, match="GMs"):
        run_simulation("megha", wl, 64, backend="simx", num_gms=2, num_lms=2,
                       faults=empty_schedule(64, 8), device="cpu")


def test_submit_reroutes_past_failed_gms_and_events_hooks():
    """The event megha's hooks the plan drives: arrivals round-robin past
    down GMs; a fully dead scheduling tier errors out."""
    cfg = MeghaConfig(num_workers=32, num_gms=4, num_lms=2)
    loop = EventLoop()
    sched = Megha(loop, RunMetrics("megha", "reroute"), cfg)
    sched.fail_gm(0)
    sched.fail_gm(1)
    for i in range(8):
        sched.submit(traces.Job(i, 0.0, [0.5] * 4))
    loop.run()
    assert all(j.finish_time == j.finish_time for j in sched.metrics.jobs)
    dead = Megha(EventLoop(), RunMetrics("megha", "dead"), cfg)
    for g in range(4):
        dead.fail_gm(g)
    with pytest.raises(RuntimeError, match="no live GM"):
        dead.submit(traces.Job(99, 0.0, [1.0]))


@pytest.mark.parametrize("name", ["megha", "pigeon", "oracle"])
def test_simx_run_simulation_with_a_plan_matches_reference(name):
    """``run_simulation(backend="simx", faults=FaultPlan)`` to completion:
    the summary and counters equal to the reference's (megha fed the
    reference's GM orders; pigeon and the oracle draw nothing), with the
    round cap stretched past the recovery."""
    kw = dict(num_jobs=6, tasks_per_job=16, load=0.6, num_workers=64, seed=4)
    cfg_kw = dict(num_gms=2, num_lms=2, dt=0.02)
    plans = [m.FaultPlan(
        worker_failures=tuple(m.WorkerFailure(w, 0.8, 1.6) for w in (1, 17, 33)),
        gm_outages=(m.GmOutage(1, 0.4, 1.2),) if name == "megha" else ())
        for m in (faults, jax_faults)]
    want_run = jax_engine.simulate_workload(name, jax_synth.synthetic_trace(**kw), 64,
                                            faults=plans[1], **cfg_kw)
    extra = {}
    if name == "megha":
        extra["orders"] = _t(jax_megha.gm_orders(jax.random.PRNGKey(0),
                                                 JaxSimxConfig(num_workers=64, num_gms=2,
                                                               num_lms=2)))
    run = simulate_workload(name, synth.synthetic_trace(**kw), 64, faults=plans[0],
                            device="cpu", **cfg_kw, **extra)
    _assert_same(convert.state_to_numpy(run.state), _np(want_run.state))
    assert run.lost_tasks == want_run.lost_tasks > 0
    assert run.tasks_completed == run.tasks.num_tasks
    got = run_simulation(name, synth.synthetic_trace(**kw), 64, backend="simx",
                         faults=plans[0], device="cpu", **cfg_kw, **extra).summary()
    want = want_run.to_run_metrics().summary()
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])) for k in want)


def test_empty_plan_builds_the_fault_free_run():
    wl = synth.synthetic_trace(num_jobs=4, tasks_per_job=8, load=0.5, num_workers=64, seed=1)
    a = simulate_workload("sparrow", wl, 64, device="cpu")
    b = simulate_workload("sparrow", wl, 64, faults=FaultPlan(), device="cpu")
    _assert_same(convert.state_to_numpy(b.state), convert.state_to_numpy(a.state))
    assert b.lost_tasks == 0


def test_fault_names_match_reference():
    """The names the port exports for faults are the reference's."""
    for name in ("FaultPlan", "FaultSchedule", "GmOutage", "WorkerFailure", "empty_schedule",
                 "fault_grid_schedule", "is_empty", "worker_dead", "apply_worker_faults",
                 "gm_down_mask", "gm_recovered_now", "gm_adoption", "jobs_with_reservation"):
        assert hasattr(faults, name) and hasattr(jax_faults, name), name
    # the package exports the backend-neutral plan, not sweep's Fig. 4 plan
    assert (FaultPlan, GmOutage, WorkerFailure) == (
        faults.FaultPlan, faults.GmOutage, faults.WorkerFailure)
    assert (JaxFaultPlan, JaxGmOutage, JaxWorkerFailure) == (
        jax_faults.FaultPlan, jax_faults.GmOutage, jax_faults.WorkerFailure)
    assert [f.name for f in dataclasses.fields(FaultSchedule)] == [
        f.name for f in dataclasses.fields(jax_faults.FaultSchedule)]
