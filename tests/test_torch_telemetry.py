"""The port's telemetry stage (``repro_torch.simx.telemetry`` and the
runtime's telemetry stage) against the JAX reference on the CPU.

For each of the five rules, on the mixed trace of
``tests/test_torch_faults.py`` (long and short jobs on 128 workers) with
no fault schedule and with the reference's crash wave (megha also under GM
outages): the run with telemetry and provenance on is bitwise the run with
both off, in the port and in the reference, and the ``Timeline`` (``t``,
every series, ``delay_hist``) is bitwise the reference's.  The stride (7)
does not divide the run (320 rounds), so the unsampled tail is covered;
the histogram's 16 bins of 0.125 s clamp the longer delays.  The
reference runs with its default jnp match and is fed nothing but its
seed; the port gets the reference's draws of that seed.  Then the engine
(``simulate_workload(telemetry=)`` in chunks of whole windows, the Chrome
counter trace as JSON) and the P² sketch on fixed numpy streams."""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import SimxConfig as JaxSimxConfig
from repro.simx import engine as jax_engine
from repro.simx import export_workload as jax_export_workload
from repro.simx import faults as jax_faults
from repro.simx import megha as jax_megha
from repro.simx import runtime as jax_rt
from repro.simx import sparrow as jax_sparrow
from repro.simx import state as jax_state
from repro.simx import telemetry as jax_tel
from repro.workload import synth as jax_synth
from repro.workload import traces as jax_traces
from repro_torch.simx import (
    SimxConfig,
    TelemetryConfig,
    Timeline,
    convert,
    faults,
    simulate_workload,
    telemetry,
)
from repro_torch.simx import runtime as rt
from repro_torch.workload import synth, traces

RULES = ["megha", "sparrow", "eagle", "pigeon", "oracle"]
#: the mixed trace's config: 128 workers on a 4 x 4 GM x LM grid
CFG = dict(num_workers=128, num_gms=4, num_lms=4, dt=0.05, heartbeat_interval=1.0)
SEED = 5
ROUNDS = 320
TEL = dict(stride=7, delay_bins=16, delay_max=2.0)
CASES = [(n, p) for n in RULES for p in ("none", "crash_wave")] + [("megha", "gm_outage")]


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


def _schedules(plan: str):
    if plan == "none":
        return None, None
    return (_plan(jax_faults, plan).to_schedule(128, 4, CFG["dt"]),
            _plan(faults, plan).to_schedule(128, 4, CFG["dt"]))


def _runs(g, name, plan):
    """(reference flags-on, reference flags-off, port flags-on, port
    flags-off) of one case; the flags-on runs are ``((state, Provenance),
    Timeline)``."""
    key = (name, plan)
    if key not in g["cache"]:
        jfs, fs = _schedules(plan)
        draws = _ref_draws(name, g["jcfg"], g["jtasks"], SEED)
        g["cache"][key] = (
            jax_rt.simulate_fixed(name, g["jcfg"], g["jtasks"], SEED, ROUNDS, faults=jfs,
                                  telemetry=jax_tel.TelemetryConfig(**TEL), provenance=True),
            jax_rt.simulate_fixed(name, g["jcfg"], g["jtasks"], SEED, ROUNDS, faults=jfs),
            rt.simulate_fixed(name, g["cfg"], g["tasks"], draws, ROUNDS, faults=fs,
                              telemetry=TelemetryConfig(**TEL), provenance=True),
            rt.simulate_fixed(name, g["cfg"], g["tasks"], draws, ROUNDS, faults=fs),
        )
    return g["cache"][key]


def _timeline_np(tl) -> dict:
    out = {"t": np.asarray(tl.t), "delay_hist": np.asarray(tl.delay_hist)}
    out.update({f"series.{k}": np.asarray(v) for k, v in tl.series.items()})
    return out


@pytest.mark.parametrize("name,plan", CASES)
def test_flags_off_is_bitwise_the_flags_on_state_and_the_reference(mixed, name, plan):
    """The telemetry and provenance stages change nothing of the run: the
    port's state with both on is bitwise its state with both off, which is
    bitwise the reference's (whose two runs agree too)."""
    (jon, _), joff, (on, _), off = _runs(mixed, name, plan)
    want = _np(joff)
    _assert_same(_np(jon[0]), want)
    _assert_same(convert.state_to_numpy(off), want)
    _assert_same(convert.state_to_numpy(on[0]), want)


@pytest.mark.parametrize("name,plan", CASES)
def test_timeline_is_bitwise_the_reference(mixed, name, plan):
    (_, jtl), _, (_, tl), _ = _runs(mixed, name, plan)
    assert isinstance(tl, Timeline)
    s = {k: v.numpy() for k, v in _timeline_np_t(tl).items()}
    _assert_same(s, _timeline_np(jtl))
    assert tl.num_samples == jtl.num_samples == ROUNDS // TEL["stride"]
    assert (tl.stride, tl.dt, tl.delay_max) == (jtl.stride, jtl.dt, jtl.delay_max)
    np.testing.assert_array_equal(tl.bin_edges, jtl.bin_edges)
    # the gauges account for every arrived task at every sample
    arrived = np.array([int((mixed["tasks"].submit <= t).sum()) for t in tl.t.tolist()])
    np.testing.assert_array_equal(
        s["series.pending"] + s["series.running"] + s["series.completed"], arrived)
    if plan != "none":
        assert s["series.lost"].sum() > 0
        assert s["series.live_workers"].min() < CFG["num_workers"]


def test_rule_extra_counters_are_the_references(mixed):
    """Each rule's own counters reach the series under the reference's
    names, and nowhere else."""
    extras = {"megha": {"view_repairs"}, "eagle": {"sss_rejections"},
              "pigeon": {"reserve_hits"}, "sparrow": set(), "oracle": set()}
    core = {"launches", "messages", "probes", "inconsistencies", "lost", "utilization",
            "pending", "running", "completed", "queue_depth", "live_workers"}
    for name, extra in extras.items():
        (_, jtl), _, (_, tl), _ = _runs(mixed, name, "none")
        queues = {"res_overflow", "probe_lag"} if name in ("sparrow", "eagle") else set()
        assert set(tl.series) == set(jtl.series) == core | extra | queues
    (_, tl) = _runs(mixed, "megha", "none")[2]
    assert int(tl.series["view_repairs"].sum()) > 0
    assert int(_runs(mixed, "eagle", "none")[2][1].series["sss_rejections"].sum()) > 0


def test_delay_histogram_matches_reference():
    """Finished delays binned, past ``delay_max`` clamped into the last
    bin, unfinished jobs left out; one point and a batch of three."""
    rng = np.random.default_rng(3)
    T, J = 60, 12
    job = np.sort(rng.integers(0, J, T)).astype(np.int32)
    job[:J] = np.arange(J)
    job.sort()
    jtasks = jax_state.TaskArrays(
        submit=jnp.zeros(T, jnp.float32), duration=jnp.ones(T, jnp.float32),
        job=jnp.asarray(job), job_submit=jnp.zeros(J, jnp.float32),
        job_ideal=jnp.ones(J, jnp.float32), job_ntasks=jnp.asarray(np.bincount(job, minlength=J)),
        job_est=jnp.ones(J, jnp.float32))
    tasks = convert.tasks_from_numpy(_np(jtasks), "cpu")
    fin = rng.uniform(1.0, 9.0, (3, T)).astype(np.float32)
    fin[1, :5] = np.inf
    t = np.array([10.0, 10.0, 4.0], np.float32)
    for tel_kw in (dict(delay_bins=8, delay_max=4.0), dict(delay_bins=3, delay_max=60.0)):
        want = [np.asarray(jax_tel.delay_histogram(jnp.asarray(fin[b]), jnp.float32(t[b]), jtasks,
                                                   jax_tel.TelemetryConfig(**tel_kw)))
                for b in range(3)]
        got = telemetry.delay_histogram(_t(fin), _t(t), tasks, TelemetryConfig(**tel_kw))
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
        assert got.dtype == torch.int32
        one = telemetry.delay_histogram(_t(fin[2]), _t(t[2]), tasks, TelemetryConfig(**tel_kw))
        np.testing.assert_array_equal(one.numpy(), want[2])


def test_config_validation_and_bin_edges():
    for kw in (dict(stride=0), dict(delay_bins=0)):
        with pytest.raises(ValueError):
            TelemetryConfig(**kw)
        with pytest.raises(ValueError):
            jax_tel.TelemetryConfig(**kw)
    assert TelemetryConfig().bin_width == jax_tel.TelemetryConfig().bin_width == 60.0 / 32
    assert telemetry.WORKER_TID_BASE == jax_tel.WORKER_TID_BASE


# ---------------------------------------------------------------------------
# the engine: chunks of whole windows, the Chrome counter trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["megha", "sparrow"])
def test_engine_timeline_and_chrome_trace_match_reference(name):
    """``simulate_workload(telemetry=)`` to completion, with a chunk (37)
    that the engine rounds down to whole windows as the reference does:
    state, Timeline and the Chrome counter trace's JSON equal the
    reference's; ``telemetry=True`` is the default config."""
    kw = dict(num_jobs=10, tasks_per_job=24, load=0.8, num_workers=64, seed=5)
    jwl, wl = jax_synth.synthetic_trace(**kw), synth.synthetic_trace(**kw)
    cfg = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, dt=0.05)
    tel = dict(stride=6, delay_bins=8, delay_max=1.0)
    want = jax_engine.simulate_workload(name, jwl, 64, seed=2, chunk=37,
                                        telemetry=jax_tel.TelemetryConfig(**tel), **cfg)
    jtasks = jax_export_workload(jwl)
    draws = _ref_draws(name, JaxSimxConfig(num_workers=64, **cfg), jtasks, 2)
    got = simulate_workload(name, wl, 64, draws=draws, chunk=37, telemetry=TelemetryConfig(**tel),
                            device="cpu", **cfg)
    _assert_same(convert.state_to_numpy(got.state), _np(want.state))
    assert got.provenance is None and got.timeline.num_samples > 0
    _assert_same({k: v.numpy() for k, v in _timeline_np_t(got.timeline).items()},
                 _timeline_np(want.timeline))
    for args in (dict(pid=3, process_name=name), dict()):
        ours = json.dumps(got.timeline.to_chrome_trace(**args))
        assert ours == json.dumps(want.timeline.to_chrome_trace(**args))
    evs = json.loads(ours)["traceEvents"]
    assert evs and all(e["ph"] == "C" for e in evs)
    default = simulate_workload(name, wl, 64, draws=draws, telemetry=True, device="cpu", **cfg)
    want = jax_engine.simulate_workload(name, jwl, 64, seed=2, telemetry=True, **cfg)
    assert default.timeline.stride == TelemetryConfig().stride == want.timeline.stride
    _assert_same(convert.state_to_numpy(default.state), _np(want.state))
    _assert_same({k: v.numpy() for k, v in _timeline_np_t(default.timeline).items()},
                 _timeline_np(want.timeline))


def _timeline_np_t(tl) -> dict:
    out = {"t": tl.t, "delay_hist": tl.delay_hist}
    out.update({f"series.{k}": v for k, v in tl.series.items()})
    return out


def test_engine_with_a_round_cap_keeps_the_tail_unsampled():
    """``until`` cuts the run inside a window: the trailing rounds advance
    the state but are not sampled, as in the reference."""
    kw = dict(num_jobs=6, tasks_per_job=16, load=0.8, num_workers=64, seed=1)
    cfg = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0, dt=0.05)
    tel = dict(stride=8)
    want = jax_engine.simulate_workload("oracle", jax_synth.synthetic_trace(**kw), 64, until=1.23,
                                        telemetry=jax_tel.TelemetryConfig(**tel), **cfg)
    got = simulate_workload("oracle", synth.synthetic_trace(**kw), 64, until=1.23,
                            telemetry=TelemetryConfig(**tel), device="cpu", **cfg)
    assert int(got.state.rnd) == int(want.state.rnd) == 25
    assert got.timeline.num_samples == want.timeline.num_samples == 3
    _assert_same({k: v.numpy() for k, v in _timeline_np_t(got.timeline).items()},
                 _timeline_np(want.timeline))


# ---------------------------------------------------------------------------
# the P² sketch
# ---------------------------------------------------------------------------


def _sketch_np(sk) -> dict:
    return {f: np.asarray(getattr(sk, f)) for f in ("q", "n", "npd", "dn", "buf", "count")}


@pytest.mark.parametrize("n,seed", [(3, 0), (5, 1), (1000, 2), (5000, 3)])
def test_sketch_is_bitwise_the_reference_on_fixed_streams(n, seed):
    """A lognormal stream with a tenth of its samples masked out; the
    sketch state after every observation's update and the estimates."""
    rng = np.random.default_rng(seed)
    values = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    mask = rng.random(n) > 0.1
    want = jax_tel.sketch_absorb(jax_tel.sketch_init(), jnp.asarray(values), jnp.asarray(mask))
    got = telemetry.sketch_absorb(telemetry.sketch_init(), values, mask)
    _assert_same({k: v.numpy() for k, v in
                  {f: getattr(got, f) for f in ("q", "n", "npd", "dn", "buf", "count")}.items()},
                 _sketch_np(want))
    np.testing.assert_array_equal(telemetry.sketch_quantiles(got).numpy(),
                                  np.asarray(jax_tel.sketch_quantiles(want)))
    assert got.targets == want.targets == telemetry.DEFAULT_QUANTILES


def test_sketch_small_samples_and_targets():
    """Below five observations the estimates are order statistics of the
    warm-up buffer (NaN with none); custom targets; bad targets refused."""
    for targets in ((0.5,), (0.1, 0.9)):
        sk, jsk = telemetry.sketch_init(targets), jax_tel.sketch_init(targets)
        np.testing.assert_array_equal(telemetry.sketch_quantiles(sk).numpy(),
                                      np.asarray(jax_tel.sketch_quantiles(jsk)))
        for x in (3.0, 1.0, 2.0, 7.0, 0.5, 4.0):
            sk, jsk = telemetry.sketch_update(sk, x, True), jax_tel.sketch_update(jsk, x, True)
            np.testing.assert_array_equal(telemetry.sketch_quantiles(sk).numpy(),
                                          np.asarray(jax_tel.sketch_quantiles(jsk)))
        sk2 = telemetry.sketch_update(sk, 100.0, False)
        assert torch.equal(sk2.q, sk.q) and int(sk2.count) == int(sk.count) == 6
    for bad in ((), (0.0,), (0.5, 1.0)):
        with pytest.raises(ValueError):
            telemetry.sketch_init(bad)


@pytest.mark.parametrize("name", ["megha", "sparrow"])
def test_batched_timeline_is_each_point_alone(name):
    """A batch of four points (2 loads x 2 seeds of the sweep tests' small
    grid) with telemetry and provenance: every point's Timeline and
    Provenance are bitwise its run alone, megha's borrow pass counted only
    at the points that needed it."""
    from repro_torch.simx import sweep

    loads, seeds = (0.5, 0.8), (0, 1)
    tasks, sub, jsub = sweep.make_load_grid(loads, num_jobs=8, tasks_per_job=16,
                                            num_workers=64, seed=11, device="cpu")
    cfg = SimxConfig(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)
    draws = sweep.seed_draws(name, cfg, tasks, seeds)
    point_tasks = tasks.replace(submit=sub.repeat_interleave(2, 0),
                                job_submit=jsub.repeat_interleave(2, 0))
    point_draws = {k: v.repeat((2,) + (1,) * (v.dim() - 1)) for k, v in draws.items()}
    tel = TelemetryConfig(stride=9, delay_bins=8, delay_max=1.0)
    (state, prov), tl = rt.simulate_fixed(name, cfg, point_tasks, point_draws, 300,
                                          telemetry=tel, provenance=True)
    assert tl.t.shape == (4, 300 // 9)
    for b in range(4):
        tk = tasks.replace(submit=sub[b // 2], job_submit=jsub[b // 2])
        (s1, p1), t1 = rt.simulate_fixed(name, cfg, tk, {k: v[b % 2] for k, v in draws.items()},
                                         300, telemetry=tel, provenance=True)
        _assert_same({k: v[b].numpy() for k, v in _timeline_np_t(tl).items()},
                     {k: v.numpy() for k, v in _timeline_np_t(t1).items()})
        _assert_same({k: v[b] for k, v in convert.state_to_numpy(prov).items()},
                     convert.state_to_numpy(p1))
        _assert_same({k: v[b] for k, v in convert.state_to_numpy(state).items()},
                     convert.state_to_numpy(s1))
