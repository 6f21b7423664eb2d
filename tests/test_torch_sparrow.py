"""The port's sparrow rule (``repro_torch.simx.sparrow``) and its queue
helpers against the JAX reference on the CPU.

Every helper is held bitwise against the reference's on the same numpy
inputs, unbatched and over a point axis of three points (each point equal
to the reference on that point alone).  Whole runs feed the reference's
probe-target table in (``repro.simx.sparrow.probe_targets(PRNGKey(seed),
...)``, the draw of its ``simulate_fixed(seed)``) and compare every field
of the final state bitwise: on the synthetic parity trace, on yahoo- and
google-like traces cut to 200 workers, with a reserve cap of 1 (probes
dropped on full queues, orphan rescue) and with a probe window of 16
(saturated insertion)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import export_workload as jax_export_workload
from repro.simx import faults as jax_faults
from repro.simx import runtime as jax_rt
from repro.simx import simulate_workload as jax_simulate_workload
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.workload import synth as jax_synth
from repro_torch.kernels.tasks import task_scan
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import (
    SimxConfig,
    SparrowState,
    convert,
    export_workload,
    faults,
    simulate_workload,
    sparrow,
    state,
)
from repro_torch.simx import runtime as rt
from repro_torch.workload import synth

#: a small synthetic trace that completes in a few hundred rounds
SYNTH = dict(num_jobs=16, tasks_per_job=32, load=0.8, num_workers=128, seed=7)
#: many small jobs on 32 workers: with one queue slot a worker, some jobs
#: lose every probe and only orphan rescue serves them
SMALL_JOBS = dict(num_jobs=40, tasks_per_job=4, load=0.9, num_workers=32, seed=7)
#: the trace-like generators cut to 200 workers (long-tailed durations)
TRACE_LIKE = dict(num_jobs=60, total_tasks=1500, num_workers=200)
TRACE_ROUNDS = 200


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


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def ref_targets(jcfg, jtasks, seed: int) -> torch.Tensor:
    """The reference's probe-target table for ``simulate_fixed(seed)``."""
    kmax = jax_state.probe_edge_layout(jcfg, jtasks)[3]
    return _t(jax_sparrow.probe_targets(jax.random.PRNGKey(seed), jcfg, jtasks, kmax))


# ---------------------------------------------------------------------------
# config and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_workers=50_000), dict(num_workers=13_000), dict(num_workers=64),
    dict(num_workers=64, reserve_cap=3, probe_window=7), dict(num_workers=1000, probe_ratio=3),
])
def test_queue_cap_and_insert_window_match_reference(kw):
    ours, theirs = SimxConfig(**kw), JaxSimxConfig(**kw)
    for edges in (0, 1, 100, 960_000, 520_912, 10**7):
        assert ours.queue_cap(edges) == theirs.queue_cap(edges)
        for kmax in (0, 1, 64, 2000):
            assert ours.insert_window(edges, kmax) == theirs.insert_window(edges, kmax)
    assert ours.short_reserved == theirs.short_reserved


def test_paper_scale_queue_sizes():
    """480 jobs x 1,000 tasks, d = 2 at 50,000 workers: P = 960,000 edges,
    R = 40 slots, a C = 30,000-edge window."""
    cfg = SimxConfig(num_workers=50_000)
    assert cfg.queue_cap(960_000) == 40
    assert cfg.insert_window(960_000, 2000) == 30_000


@pytest.mark.parametrize("trace", ["synth", "yahoo", "google"])
@pytest.mark.parametrize("short_only", [False, True])
def test_probe_edge_layout_matches_reference(trace, short_only):
    jwl = {"synth": lambda: jax_synth.synthetic_trace(**SYNTH),
           "yahoo": lambda: jax_synth.yahoo_like_trace(**TRACE_LIKE, seed=1),
           "google": lambda: jax_synth.google_like_trace(**TRACE_LIKE, seed=2)}[trace]()
    jtasks = jax_export_workload(jwl)
    kw = dict(num_workers=200, probe_ratio=3)
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    got = state.probe_edge_layout(SimxConfig(**kw), tasks, short_only=short_only)
    want = jax_state.probe_edge_layout(JaxSimxConfig(**kw), jtasks, short_only=short_only)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]


def test_init_sparrow_state_matches_reference_and_batches():
    jtasks = jax_export_workload(jax_synth.synthetic_trace(**SYNTH))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    cfg = SimxConfig(num_workers=128)
    one = sparrow.RULE.init(cfg, tasks)
    assert isinstance(one, SparrowState)
    _assert_same(convert.state_to_numpy(one),
                 _np(jax_state.init_sparrow_state(JaxSimxConfig(num_workers=128), jtasks)))
    grid = sparrow.RULE.init(cfg, tasks, 3)
    assert grid.resq.shape == (3,) + one.resq.shape and grid.probe_head.shape == (3,)


# ---------------------------------------------------------------------------
# the queue helpers, bitwise, unbatched and on a point axis
# ---------------------------------------------------------------------------


def _late_bind_case(rng):
    ntasks = rng.integers(1, 7, 9)
    J, T, W = ntasks.size, int(ntasks.sum()), 24
    job = np.repeat(np.arange(J), ntasks).astype(np.int32)
    job_start = np.concatenate([[0], np.cumsum(ntasks)[:-1]]).astype(np.int32)
    pend = rng.random(T) < 0.6
    pick = rng.integers(0, J + 1, W).astype(np.int32)   # J = no claim
    return pick, pend, job, job_start


def _insert_case(rng, W=12, R=4, C=20, J=9):
    """Queues partly filled (ascending job ids, J = empty) and a window
    whose targets repeat (same-round duplicates of one job merge), hit
    jobs already queued (merge) and overfill some queues (overflow)."""
    fill = rng.integers(0, R + 1, W).astype(np.int32)
    resq = np.full((W, R), J, np.int32)
    for w in range(W):
        resq[w, : fill[w]] = np.sort(rng.choice(J // 2, fill[w], replace=False))
    jobs = np.sort(rng.integers(J // 2 - 1, J, C)).astype(np.int32)
    targets = rng.integers(0, W // 2, C).astype(np.int32)
    targets[1] = targets[0]
    jobs[1] = jobs[0]
    ins = np.arange(C) < rng.integers(C // 2, C + 1)
    return resq, fill, targets, jobs, ins


def _compact_case(rng, W=10, R=6, J=8, T=40):
    resq = np.where(rng.random((W, R)) < 0.7, rng.integers(0, J, (W, R)), J).astype(np.int32)
    job = np.sort(rng.integers(0, J, T)).astype(np.int32)
    fin = rng.uniform(0, 4, T).astype(np.float32)
    fin[rng.random(T) < 0.3] = np.inf
    return resq, fin, job, np.float32(2.0), J


def _window_case(rng, J=7, C=6):
    k = rng.integers(0, 5, J)
    edge_job_real = np.repeat(np.arange(J), k).astype(np.int32)
    P = edge_job_real.size
    edge_job = np.concatenate([edge_job_real, np.full(C, J)]).astype(np.int32)
    edge_worker = np.concatenate([rng.integers(0, 30, P), np.zeros(C)]).astype(np.int32)
    sub = np.sort(rng.uniform(0, 3, J)).astype(np.float32)
    job_submit_pad = np.concatenate([sub, [np.inf]]).astype(np.float32)
    head = np.int32(rng.integers(0, P + 1))
    t = np.float32(rng.uniform(0, 3.5))
    return edge_job, edge_worker, head, C, job_submit_pad, t


HELPERS = ["late_bind", "insert_probes", "compact_queues", "queue_head_pick",
           "probe_window_slice", "jobs_with_reservation"]


def _helper_args(name, rng):
    if name == "late_bind":
        return _late_bind_case(rng)
    if name == "insert_probes":
        return _insert_case(rng)
    if name == "compact_queues":
        return _compact_case(rng)
    if name == "queue_head_pick":
        resq = np.sort(rng.integers(0, 9, (16, 5)), axis=1).astype(np.int32)
        return resq, rng.random((16, 5)) < 0.4, 9
    if name == "probe_window_slice":
        return _window_case(rng)
    if name == "jobs_with_reservation":
        resq = np.where(rng.random((12, 5)) < 0.5, rng.integers(0, 9, (12, 5)), 9)
        return resq.astype(np.int32), 9
    raise KeyError(name)


def _pending_of(pend, job, num_jobs):
    """``(pending, plist)`` of the pending mask ``pend`` (the port's
    ``late_bind`` reads these, the reference's the mask): the task scan
    with every pending task unlaunched and submitted at t = 0, every other
    one finished."""
    fin = torch.where(pend, math.inf, 0.0)
    zero = torch.zeros(pend.shape[:-1])
    _, pending, plist = task_scan(fin, torch.zeros_like(fin), job, zero, num_jobs)
    return pending, plist


def _call(mod, name, args, torch_side: bool):
    conv = (lambda a: _t(a) if isinstance(a, (np.ndarray, np.generic)) else a) if torch_side \
        else (lambda a: jnp.asarray(a) if isinstance(a, (np.ndarray, np.generic)) else a)
    args = [conv(a) for a in args]
    if name == "late_bind" and torch_side:
        pick, pend, job, job_start = args
        out = mod.late_bind(pick, *_pending_of(pend, job, job_start.shape[-1]))
    elif name == "queue_head_pick":
        resq, active, J = args
        fn = rt.default_match_fn() if torch_side else jax_rt.default_match_fn()
        out = mod.queue_head_pick(resq, active, fn, J)
    elif name == "jobs_with_reservation":
        out = mod.jobs_with_reservation(*args)
    else:
        out = getattr(mod, name)(*args)
    return out if isinstance(out, tuple) else (out,)


def _torch_mod(name):
    return faults if name == "jobs_with_reservation" else sparrow


def _jax_mod(name):
    return jax_faults if name == "jobs_with_reservation" else jax_sparrow


@pytest.mark.parametrize("name", HELPERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_helper_matches_reference(name, seed):
    args = _helper_args(name, np.random.default_rng(seed))
    got = _call(_torch_mod(name), name, args, True)
    want = _call(_jax_mod(name), name, args, False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


def _point_args(name, base, rng):
    """One more point's arguments over ``base``'s shared structure (the
    job layout, the edge list, the number of jobs)."""
    if name == "late_bind":
        pick, pend, job, job_start = base
        return (rng.integers(0, job_start.size + 1, pick.size).astype(np.int32),
                rng.random(pend.size) < 0.6, job, job_start)
    if name == "compact_queues":
        resq, fin, job, _, J = _compact_case(rng)
        return resq, fin, base[2], np.float32(rng.uniform(1, 3)), base[4]
    if name == "probe_window_slice":
        edge_job, _, _, C, pad, _ = base
        P = int((edge_job < pad.size - 1).sum())
        sub = np.sort(rng.uniform(0, 3, pad.size - 1)).astype(np.float32)
        return (edge_job, rng.integers(0, 30, edge_job.size).astype(np.int32),
                np.int32(rng.integers(0, P + 1)), C,
                np.concatenate([sub, [np.inf]]).astype(np.float32),
                np.float32(rng.uniform(0, 3.5)))
    return _helper_args(name, rng)  # every argument is the point's own


#: per helper, which arguments carry the point axis (the rest are shared)
POINT_ARGS = {
    "late_bind": (0, 1),
    "insert_probes": (0, 1, 2, 3, 4),
    "compact_queues": (0, 1, 3),
    "queue_head_pick": (0, 1),
    "probe_window_slice": (1, 2, 4, 5),
    "jobs_with_reservation": (0,),
}


@pytest.mark.parametrize("name", HELPERS)
def test_queue_helper_on_a_point_axis_is_each_point_alone(name):
    """Three points stacked on a leading axis: each point of the batched
    call is the reference's call on that point alone."""
    base = _helper_args(name, np.random.default_rng(7))
    points = [_point_args(name, base, np.random.default_rng(100 + b)) for b in range(3)]
    stacked = [np.stack([p[i] for p in points]) if i in POINT_ARGS[name] else base[i]
               for i in range(len(base))]
    got = _call(_torch_mod(name), name, stacked, True)
    for b, args in enumerate(points):
        want = _call(_jax_mod(name), name, args, False)
        for g, w in zip(got, want):
            _eq(g[b], w)


def test_insert_probes_merges_and_overflows():
    """The insertion case exercises both the merges and the overflow."""
    resq, fill, targets, jobs, ins = _insert_case(np.random.default_rng(0))
    out, n_over = sparrow.insert_probes(_t(resq), _t(fill), _t(targets), _t(jobs), _t(ins))
    assert int(n_over) > 0
    kept = int((out < 9).sum() - (resq < 9).sum())
    assert kept + int(n_over) < int(ins.sum())   # some edges merged


@pytest.mark.parametrize("seed", [0, 3])
def test_probe_mask_and_edges_match_reference_given_its_targets(seed):
    jtasks = jax_export_workload(jax_synth.yahoo_like_trace(**TRACE_LIKE, seed=1))
    jcfg, cfg = JaxSimxConfig(num_workers=200), SimxConfig(num_workers=200)
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    key = jax.random.PRNGKey(seed)
    targets = ref_targets(jcfg, jtasks, seed)
    _eq(sparrow.probe_mask(targets, cfg, tasks), jax_sparrow.probe_mask(key, jcfg, jtasks))
    got = sparrow.build_probe_edges(targets, cfg, tasks)
    want = jax_sparrow.build_probe_edges(key, jcfg, jtasks)
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)
    assert got[3:] == want[3:]
    batched = sparrow.build_probe_edges(torch.stack([targets, targets.flip(0)]), cfg, tasks)
    assert torch.equal(batched[1][0], got[1]) and batched[1].shape[0] == 2


def test_probe_targets_draws_distinct_workers_per_job():
    tk = export_workload(
        synth.synthetic_trace(num_jobs=7, tasks_per_job=5, num_workers=300, seed=0), "cpu")
    cfg = SimxConfig(num_workers=300)
    a = sparrow.probe_targets(torch.Generator().manual_seed(1), cfg, tk, 10)
    b = sparrow.probe_targets(torch.Generator().manual_seed(1), cfg, tk, 10)
    assert a.dtype == torch.int32 and a.shape == (7, 10) and torch.equal(a, b)
    assert all(len(set(r)) == 10 for r in a.tolist())
    assert int(a.min()) >= 0 and int(a.max()) < 300
    mask = sparrow.probe_mask(a, cfg, tk)
    assert mask.sum(1).tolist() == [10] * 7


# ---------------------------------------------------------------------------
# whole runs against the reference, its draws fed in
# ---------------------------------------------------------------------------


def _trace(kind: str, m):
    if kind == "synth":
        return m.synthetic_trace(**SYNTH)
    if kind == "small_jobs":
        return m.synthetic_trace(**SMALL_JOBS)
    if kind == "yahoo":
        return m.yahoo_like_trace(**TRACE_LIKE, seed=1)
    return m.google_like_trace(**TRACE_LIKE, seed=2)


#: (trace, config, rounds: None = the reference's run to completion)
RUNS = {
    "synth": ("synth", dict(num_workers=128, dt=0.05), None),
    "yahoo": ("yahoo", dict(num_workers=200, dt=0.05), TRACE_ROUNDS),
    "google": ("google", dict(num_workers=200, dt=0.05), TRACE_ROUNDS),
    "small_cap": ("small_jobs", dict(num_workers=32, dt=0.05, reserve_cap=1), None),
    "small_window": ("synth", dict(num_workers=128, dt=0.05, probe_window=16), None),
}


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, case: str, seed: int = 0):
    if case not in runs:
        kind, kw, rounds = RUNS[case]
        jtasks = jax_export_workload(_trace(kind, jax_synth))
        jcfg = JaxSimxConfig(**kw)
        ref = None
        if rounds is None:
            ref = jax_simulate_workload("sparrow", _trace(kind, jax_synth), kw["num_workers"],
                                        seed=seed, **{k: v for k, v in kw.items()
                                                      if k != "num_workers"})
            rounds = int(ref.state.rnd)
        want = jax_rt.simulate_fixed("sparrow", jcfg, jtasks, seed, rounds)
        tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
        got = rt.simulate_fixed("sparrow", SimxConfig(**kw), tasks,
                                {"targets": ref_targets(jcfg, jtasks, seed)}, rounds)
        runs[case] = (want, got, ref, rounds)
    return runs[case]


@pytest.mark.parametrize("case", list(RUNS))
def test_simulate_fixed_matches_reference(runs, case):
    want, got, _, _ = _run(runs, case)
    assert isinstance(got, SparrowState)
    _assert_same(convert.state_to_numpy(got), _np(want))
    assert int(got.probes) > 0


def test_small_cap_overflows_and_rescues_orphans(runs):
    """With one slot a worker, probes are dropped on full queues; jobs
    whose every probe was dropped are served by orphan rescue, so the run
    still completes every task."""
    want, got, _, rounds = _run(runs, "small_cap")
    assert int(got.res_overflow) > 0
    assert int(torch.sum(got.task_finish <= got.t)) == got.task_finish.numel()
    # replay to the first round that leaves an inserted pending job with
    # no reservation anywhere: the rescue path's trigger
    jtasks = jax_export_workload(_trace("small_jobs", jax_synth))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    cfg = SimxConfig(**RUNS["small_cap"][1])
    targets = ref_targets(JaxSimxConfig(**RUNS["small_cap"][1]), jtasks, 0)
    step = sparrow.make_sparrow_step(cfg, tasks, targets)
    _, _, edge_end, _, _ = sparrow.build_probe_edges(targets, cfg, tasks)
    s = sparrow.RULE.init(cfg, tasks)
    orphaned = 0
    for _ in range(rounds):
        s = step(s)
        pend = torch.isinf(s.task_finish) & (tasks.submit <= s.t)
        pend_job = torch.zeros(tasks.num_jobs, dtype=torch.int32).scatter_add(
            0, tasks.job.long(), pend.to(torch.int32)) > 0
        orphaned += int((pend_job & (edge_end <= s.probe_head)
                         & ~faults.jobs_with_reservation(s.resq, tasks.num_jobs)).sum())
        if orphaned:
            break
    assert orphaned > 0


def test_small_window_lags(runs):
    want, got, _, _ = _run(runs, "small_window")
    assert int(got.probe_lag) > 0 and int(got.res_overflow) == 0


def test_simulate_workload_and_run_simulation_match_reference(runs):
    """The entry points with the reference's draws fed in: the final state
    of ``simulate_workload`` (its done probe stops where the reference's
    does), and ``run_simulation``'s summary (waits at the worker)."""
    _, _, ref, _ = _run(runs, "synth")
    jtasks = jax_export_workload(_trace("synth", jax_synth))
    draws = {"targets": ref_targets(JaxSimxConfig(num_workers=128), jtasks, 0)}
    wl = _trace("synth", synth)
    run = simulate_workload("sparrow", wl, 128, dt=0.05, draws=draws, device="cpu")
    _assert_same(convert.state_to_numpy(run.state), _np(ref.state))
    m = run_simulation("sparrow", wl, 128, backend="simx", dt=0.05, draws=draws, device="cpu")
    want = ref.to_run_metrics().summary()
    got = m.summary()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k
    assert m.probes == int(ref.state.probes)
    assert all(t.d_queue_scheduler == 0.0 for t in m.tasks)


def test_standalone_run_draws_from_its_seed():
    """Without draws, ``seed`` seeds a ``torch.Generator`` (the reference
    draws from ``PRNGKey(seed)``: the two agree in distribution only); the
    same seed gives the same run, another seed another."""
    wl = synth.synthetic_trace(num_jobs=6, tasks_per_job=16, load=0.8, num_workers=64, seed=2)
    a, b, c = (simulate_workload("sparrow", wl, 64, dt=0.05, seed=s, device="cpu")
               for s in (3, 3, 4))
    assert torch.equal(a.state.task_finish, b.state.task_finish)
    assert torch.equal(a.state.worker_task, b.state.worker_task)
    assert not torch.equal(a.state.worker_task, c.state.worker_task)
    assert a.tasks_completed == c.tasks_completed == 96
