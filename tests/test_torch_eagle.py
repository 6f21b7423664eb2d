"""The port's eagle rule (``repro_torch.simx.eagle``) against the JAX
reference on the CPU.

Whole runs feed the reference's draws in (``k1, k2, k3 =
split(PRNGKey(seed), 3)``: the short jobs' probe-target table from
``k1``, the re-route rotations ``off1``/``off2`` from ``randint`` on
``k2``/``k3``, the draws of its ``simulate_fixed(seed)``) and compare
every field of the final state bitwise: on a synthetic trace (no long
job: SSS and the central match compiled out), on a trace mixing short and
long jobs and on yahoo- and google-like traces cut to 200 workers (SSS
re-routing and the central long match), with a reserve cap of 1 (probes
dropped on full queues, orphan rescue) and with a probe window of 16
(saturated insertion)."""

import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import eagle as jax_eagle
from repro.simx import export_workload as jax_export_workload
from repro.simx import runtime as jax_rt
from repro.simx import simulate_workload as jax_simulate_workload
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import (
    EagleState,
    SimxConfig,
    convert,
    eagle,
    export_workload,
    simulate_workload,
)
from repro_torch.simx import runtime as rt
from repro_torch.workload import traces

SYNTH = dict(num_jobs=16, tasks_per_job=32, load=0.8, num_workers=128, seed=7)
SMALL_JOBS = dict(num_jobs=40, tasks_per_job=4, load=0.9, num_workers=32, seed=7)
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


def ref_draws(jcfg, jtasks, seed: int) -> dict:
    """The reference's draws for eagle's ``simulate_fixed(seed)``."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    kmax = jax_state.probe_edge_layout(jcfg, jtasks, short_only=True)[3]
    J = jtasks.num_jobs
    return {
        "targets": _t(jax_sparrow.probe_targets(k1, jcfg, jtasks, kmax)),
        "off1": _t(jax.random.randint(k2, (J,), 0, jcfg.num_workers, jnp.int32)),
        "off2": _t(jax.random.randint(k3, (J,), 0, jcfg.short_reserved, jnp.int32)),
    }


def _mixed_trace(m):
    """24 jobs of 4-24 tasks, every fourth one long (11-13 s, estimate
    above the 10 s threshold), the rest 0.2-1.5 s; module ``m``'s
    ``Job``/``Workload``."""
    rng = random.Random(5)
    jobs, t = [], 0.0
    for i in range(24):
        n = rng.randint(4, 24)
        lo, hi = (11.0, 13.0) if i % 4 == 1 else (0.2, 1.5)
        jobs.append(m.Job(job_id=i, submit_time=t,
                          durations=[rng.uniform(lo, hi) for _ in range(n)]))
        t += rng.expovariate(4.0)
    return m.Workload(name="mixed", jobs=jobs)


def _trace(kind: str, synth_mod, traces_mod):
    if kind == "synth":
        return synth_mod.synthetic_trace(**SYNTH)
    if kind == "small_jobs":
        return synth_mod.synthetic_trace(**SMALL_JOBS)
    if kind == "mixed":
        return _mixed_trace(traces_mod)
    if kind == "yahoo":
        return synth_mod.yahoo_like_trace(**TRACE_LIKE, seed=1)
    return synth_mod.google_like_trace(**TRACE_LIKE, seed=2)


#: (trace, config, rounds: None = the reference's run to completion)
RUNS = {
    "synth": ("synth", dict(num_workers=128, dt=0.05), None),
    "mixed": ("mixed", dict(num_workers=100, dt=0.05), None),
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
        jtasks = jax_export_workload(_trace(kind, jax_synth, jax_traces))
        jcfg = JaxSimxConfig(**kw)
        ref = None
        if rounds is None:
            ref = jax_simulate_workload(
                "eagle", _trace(kind, jax_synth, jax_traces), kw["num_workers"], seed=seed,
                **{k: v for k, v in kw.items() if k != "num_workers"})
            rounds = int(ref.state.rnd)
        want = jax_rt.simulate_fixed("eagle", jcfg, jtasks, seed, rounds)
        tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
        got = rt.simulate_fixed("eagle", SimxConfig(**kw), tasks,
                                ref_draws(jcfg, jtasks, seed), rounds)
        runs[case] = (want, got, ref, tasks)
    return runs[case]


@pytest.mark.parametrize("case", list(RUNS))
def test_simulate_fixed_matches_reference(runs, case):
    want, got, _, _ = _run(runs, case)
    assert isinstance(got, EagleState)
    _assert_same(convert.state_to_numpy(got), _np(want))


@pytest.mark.parametrize("case", ["mixed", "yahoo", "google"])
def test_long_jobs_take_the_sss_and_central_paths(runs, case):
    """Where long jobs run, probes are rejected by SSS (probes counted past
    the inserted edges) and the central FIFO launches long tasks."""
    _, got, _, tasks = _run(runs, case)
    assert int(got.probes) > int(got.probe_head)
    long_task = (tasks.job_est >= 10.0)[tasks.job.long()]
    assert int(got.long_head) > 0
    assert int((~torch.isinf(got.task_finish) & long_task).sum()) > 0


def test_short_only_trace_compiles_the_long_path_out(runs):
    """Every job short: no rejection, no central head, one match a round
    (the pick)."""
    _, got, _, _ = _run(runs, "synth")
    assert int(got.probes) == int(got.probe_head) and int(got.long_head) == 0
    jtasks = jax_export_workload(_trace("synth", jax_synth, jax_traces))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    cfg = SimxConfig(num_workers=128, dt=0.05)
    calls = []

    def counting(avail, n):
        calls.append(tuple(avail.shape))
        return rt.default_match_fn()(avail, n)

    step = eagle.make_eagle_step(cfg, tasks, ref_draws(JaxSimxConfig(**RUNS["synth"][1]),
                                                       jtasks, 0), counting)
    rt.scan_rounds(step, eagle.RULE.init(cfg, tasks), 5)
    R = eagle.RULE.init(cfg, tasks).resq.shape[-1]
    assert calls == [(128, R)] * 5


def test_long_path_matches_per_round_with_two_matches(runs):
    """With long jobs each round runs two matches: the narrow pick over
    ``[W, R]`` and the wide central match over ``[1, W]``."""
    jtasks = jax_export_workload(_mixed_trace(jax_traces))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    cfg = SimxConfig(num_workers=100, dt=0.05)
    calls = []

    def counting(avail, n):
        calls.append(tuple(avail.shape))
        return rt.default_match_fn()(avail, n)

    step = eagle.make_eagle_step(cfg, tasks, ref_draws(JaxSimxConfig(num_workers=100, dt=0.05),
                                                       jtasks, 0), counting)
    rt.scan_rounds(step, eagle.RULE.init(cfg, tasks), 3)
    R = eagle.RULE.init(cfg, tasks).resq.shape[-1]
    assert calls == [(100, R), (1, 100)] * 3


def test_small_cap_overflows_and_completes(runs):
    want, got, _, _ = _run(runs, "small_cap")
    assert int(got.res_overflow) > 0
    assert int(torch.sum(got.task_finish <= got.t)) == got.task_finish.numel()


def test_small_window_lags(runs):
    _, got, _, _ = _run(runs, "small_window")
    assert int(got.probe_lag) > 0


def test_eagle_probe_mask_matches_reference():
    jtasks = jax_export_workload(_mixed_trace(jax_traces))
    jcfg, cfg = JaxSimxConfig(num_workers=100), SimxConfig(num_workers=100)
    key = jax.random.PRNGKey(4)
    kmax = jax_state.probe_edge_layout(jcfg, jtasks)[3]
    targets = _t(jax_sparrow.probe_targets(key, jcfg, jtasks, kmax))
    got = eagle.eagle_probe_mask(targets, cfg, convert.tasks_from_numpy(_np(jtasks), "cpu"))
    want = np.asarray(jax_eagle.eagle_probe_mask(key, jcfg, jtasks))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < want.size


def test_init_eagle_state_matches_reference():
    jtasks = jax_export_workload(_mixed_trace(jax_traces))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    got = eagle.RULE.init(SimxConfig(num_workers=100), tasks)
    want = jax_state.init_eagle_state(JaxSimxConfig(num_workers=100), jtasks)
    _assert_same(convert.state_to_numpy(got), _np(want))
    grid = eagle.RULE.init(SimxConfig(num_workers=100), tasks, 2)
    assert grid.long_head.shape == (2,) and grid.resq.shape == (2,) + got.resq.shape


def test_draws_have_the_reference_shapes_and_ranges():
    tasks = export_workload(_mixed_trace(traces), "cpu")
    cfg = SimxConfig(num_workers=100)
    d = eagle.draw(cfg, tasks, torch.Generator().manual_seed(0))
    ref = ref_draws(JaxSimxConfig(num_workers=100), jax_export_workload(
        _mixed_trace(jax_traces)), 0)
    assert d.keys() == ref.keys()
    for k in d:
        assert d[k].dtype == ref[k].dtype and d[k].shape == ref[k].shape, k
    assert int(d["off1"].max()) < 100 and int(d["off2"].max()) < cfg.short_reserved
    assert int(d["off1"].min()) >= 0 and int(d["off2"].min()) >= 0


def test_simulate_workload_and_run_simulation_match_reference(runs):
    """The entry points on the mixed trace, the reference's draws fed in:
    the final state bitwise, and the summary with short-job waits at the
    worker and long-job waits at the central scheduler."""
    _, _, ref, _ = _run(runs, "mixed")
    jtasks = jax_export_workload(_mixed_trace(jax_traces))
    draws = ref_draws(JaxSimxConfig(num_workers=100, dt=0.05), jtasks, 0)
    wl = _mixed_trace(traces)
    run = simulate_workload("eagle", wl, 100, dt=0.05, draws=draws, device="cpu")
    _assert_same(convert.state_to_numpy(run.state), _np(ref.state))
    m = run_simulation("eagle", wl, 100, backend="simx", dt=0.05, draws=draws, device="cpu")
    want = ref.to_run_metrics().summary()
    got = m.summary()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k
    wants = ref.to_run_metrics().tasks
    assert [(t.d_queue_worker, t.d_queue_scheduler) for t in m.tasks] == \
        [(t.d_queue_worker, t.d_queue_scheduler) for t in wants]
    assert any(t.d_queue_scheduler > 0 for t in m.tasks)
    assert any(t.d_queue_worker > 0 for t in m.tasks)


def test_knobs_reach_the_rule():
    """``simulate_workload``'s eagle knobs, each moved, with the
    reference's draws: the same final state as the reference's run with
    those knobs."""
    kw = dict(short_partition_fraction=0.3, probe_ratio=3, long_threshold=12.0, reserve_cap=4)
    wl_j = _mixed_trace(jax_traces)
    ref = jax_simulate_workload("eagle", wl_j, 100, dt=0.05, seed=1, **kw)
    jtasks = jax_export_workload(wl_j)
    draws = ref_draws(JaxSimxConfig(num_workers=100, dt=0.05, **kw), jtasks, 1)
    run = simulate_workload("eagle", _mixed_trace(traces), 100, dt=0.05, draws=draws,
                            device="cpu", **kw)
    _assert_same(convert.state_to_numpy(run.state), _np(ref.state))
