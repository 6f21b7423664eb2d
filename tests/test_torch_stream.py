"""The port's streaming steady-state engine (``repro_torch.simx.stream``)
against the reference's (``repro.simx.stream``), on the CPU.

The reference's own configuration (``tests/test_simx_streaming.py``):
128 workers on a 4 x 4 grid, a 60-job synthetic trace replayed through a
full-capacity window and through a small one (8 jobs / 80 tasks, 16
rounds a refill).  Every rule's streamed run is bitwise the reference's:
retired delays, every series (NaN-aware), the refills, the sketch
estimates and the counters, with and without telemetry and provenance.
Megha is fed the reference's GM orders; sparrow and eagle need nothing fed
in, since both packages draw each job's probe targets with the same numpy
calls at admission.  On top: the layouts after admission and refills, the
reference's own pins held against the port's fixed path, conservation,
determinism, the O(W + window) state bytes, and the refusals."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.simx import megha as jax_megha
from repro.simx import stream as jax_stream
from repro.workload import synth as jax_synth
from repro_torch.simx import simulate_workload
from repro_torch.simx import eagle, megha, pigeon, sparrow, stream
from repro_torch.simx import telemetry as tlm
from repro_torch.simx.faults import empty_schedule
from repro_torch.workload import synth

RULES = ("megha", "sparrow", "eagle", "pigeon", "oracle")
#: rules whose streamed path replays the fixed path's exact decisions
EXACT = ("megha", "pigeon", "oracle")

W, GMS, LMS = 128, 4, 4
_TRACE = dict(num_jobs=60, tasks_per_job=8, task_duration=1.0, load=0.7,
              num_workers=W, seed=3)
FULL = dict(window_jobs=60, window_tasks=480, rounds_per_refill=64)
SMALL = dict(window_jobs=8, window_tasks=80, rounds_per_refill=16)
WINDOWS = {"full": FULL, "small": SMALL}
COMMON = dict(num_gms=GMS, num_lms=LMS, seed=0)
COUNTERS = ("jobs_admitted", "jobs_completed", "tasks_admitted", "tasks_completed",
            "lost", "messages", "probes", "rounds", "end_time")


@functools.lru_cache(maxsize=None)
def _ref_orders(window_tasks: int) -> torch.Tensor:
    cfg = jax_stream.stream_config("megha", W, window_tasks=window_tasks, **COMMON)
    return torch.from_numpy(np.array(jax_megha.gm_orders(jax.random.PRNGKey(0), cfg)))


def _arrivals(pkg, kind: str):
    if kind == "bimodal":
        # trace-like short/long mixture: eagle's SSS and central FIFO and
        # pigeon's low-priority class see work
        return pkg.PoissonArrivals(rate=3.0, job_factory=pkg.bimodal_job_factory(8),
                                   seed=5, num_jobs=24)
    return pkg.ReplayArrivals(pkg.synthetic_trace(**_TRACE))


def _kw(window: str, flags: bool, kind: str) -> dict:
    kw = dict(WINDOWS[window], **COMMON)
    if kind == "bimodal":
        kw["horizon"] = 12.0
    if flags:
        kw.update(telemetry=True, provenance=True)
    return kw


@functools.lru_cache(maxsize=None)
def _ref_run(rule: str, window: str, flags: bool = False, kind: str = "replay"):
    return jax_stream.run_steady_state(rule, _arrivals(jax_synth, kind), W,
                                       **_kw(window, flags, kind))


@functools.lru_cache(maxsize=None)
def _port_run(rule: str, window: str, flags: bool = False, kind: str = "replay"):
    kw = _kw(window, flags, kind)
    if rule == "megha":
        kw["orders"] = _ref_orders(kw["window_tasks"])
    return stream.run_steady_state(rule, _arrivals(synth, kind), W, device="cpu", **kw)


def _assert_runs_bitwise(ref, got, rule: str) -> None:
    assert np.array_equal(ref.delays, got.delays)
    assert set(ref.series) == set(got.series)
    for k in ref.series:
        assert np.array_equal(np.asarray(ref.series[k]), got.series[k], equal_nan=True), k
    assert ref.refills == got.refills
    assert np.array_equal(np.asarray(ref.quantile_estimates), got.quantile_estimates,
                          equal_nan=True)
    assert ref.quantile_targets == got.quantile_targets
    for f in COUNTERS:
        assert getattr(ref, f) == getattr(got, f), f
    if rule == "pigeon":
        # the port's pigeon rows are as wide as one group can fill
        assert got.state_bytes < ref.state_bytes
    else:
        assert got.state_bytes == ref.state_bytes


@pytest.mark.parametrize("window", ["full", "small"])
@pytest.mark.parametrize("rule", RULES)
def test_stream_bitwise_the_reference(rule, window):
    _assert_runs_bitwise(_ref_run(rule, window), _port_run(rule, window), rule)


@pytest.mark.parametrize("rule", RULES)
def test_stream_bitwise_the_reference_on_bimodal_arrivals(rule):
    """Open-loop Poisson arrivals of short and long jobs, to a horizon:
    eagle's SSS re-routes and central long FIFO and pigeon's low class
    run, and the window stays busy when the horizon cuts the run."""
    ref, got = _ref_run(rule, "small", kind="bimodal"), _port_run(rule, "small", kind="bimodal")
    _assert_runs_bitwise(ref, got, rule)
    if rule == "eagle":
        assert got.probes > 0


@pytest.mark.parametrize("rule", RULES)
def test_stream_telemetry_and_provenance_bitwise_the_reference(rule):
    """Telemetry and provenance on: the refill-merged ``Timeline`` and the
    harvested ``breakdown`` equal the reference's, and the run itself is
    unchanged."""
    ref, got = _ref_run(rule, "small", True), _port_run(rule, "small", True)
    _assert_runs_bitwise(ref, got, rule)
    _assert_runs_bitwise(ref, _port_run(rule, "small"), rule)
    rt_, gt_ = ref.timeline, got.timeline
    assert np.array_equal(np.asarray(rt_.t), gt_.t.numpy())
    assert set(rt_.series) == set(gt_.series)
    for k in rt_.series:
        assert np.array_equal(np.asarray(rt_.series[k]), gt_.series[k].numpy()), k
    assert np.array_equal(np.asarray(rt_.delay_hist), gt_.delay_hist.numpy())
    assert (rt_.stride, rt_.dt, rt_.delay_max) == (gt_.stride, gt_.dt, gt_.delay_max)
    rb, gb = ref.breakdown, got.breakdown
    assert rb["jobs"] == gb["jobs"] > 0
    assert np.array_equal(rb["bin_edges"], gb["bin_edges"])
    for c in rb["hist"]:
        assert np.array_equal(rb["hist"][c], gb["hist"][c]), c
    assert rb["sum"] == gb["sum"] and rb["mean"] == gb["mean"]


# ---------------------------------------------------------------------------
# layouts: after admission and after refills, against the reference's
# ---------------------------------------------------------------------------


def _layout_arrays(layout) -> dict:
    out = {}
    if layout is None:   # the oracle's window is its layout
        return out
    for f in dataclasses.fields(layout):
        v = getattr(layout, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in _layout_arrays(v).items()})
        else:
            out[f.name] = v if isinstance(v, int) else np.asarray(
                v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_layouts_equal(ref_win, port_win, rule: str) -> None:
    ra = _layout_arrays(ref_win.layout())
    ga = _layout_arrays(port_win.layout())
    assert set(ra) == set(ga)
    for k in ra:
        if isinstance(ra[k], int):
            assert ra[k] == ga[k], k
            continue
        r, g = ra[k], ga[k]
        if rule == "pigeon" and k.endswith("_fifo"):
            # the port's rows are as wide as one group can fill: the same
            # entries, and the reference's rows hold only sentinels beyond
            assert g.shape[1] < r.shape[1]
            assert np.array_equal(r[:, : g.shape[1]], g), k
            assert np.all(r[:, g.shape[1]:] == ref_win.T_cap), k
        else:
            assert r.dtype == g.dtype and np.array_equal(r, g), k


@pytest.mark.parametrize("rule", RULES)
def test_layouts_equal_the_reference_after_admission_and_refills(rule):
    """Both windows admit the same bimodal stream; then, three times, the
    first jobs of the window finish (their tasks get finish times at or
    before the boundary) and both windows refill.  The layouts (pigeon's
    vectorised per-group build included), the heads and the remapped
    arrays agree after each step."""
    jax_cfg = jax_stream.stream_config(rule, W, window_tasks=80, **COMMON)
    cfg = stream.stream_config(rule, W, window_tasks=80, num_gms=GMS, num_lms=LMS)
    ref_win = jax_stream._StreamWindow(_arrivals(jax_synth, "bimodal"), jax_cfg, rule,
                                       8, 80, 0)
    port_win = stream._StreamWindow(_arrivals(synth, "bimodal"), cfg, rule, 8, 80, 0,
                                    torch.device("cpu"))
    _assert_layouts_equal(ref_win, port_win, rule)
    from repro.simx import runtime as jax_rt
    from repro_torch.simx import runtime as rt

    ref_state = jax_rt.get_rule(rule).init(jax_cfg, ref_win.tasks())
    port_state = rt.batch_state(rt.get_rule(rule).init(cfg, port_win.tasks()))
    for step in range(3):
        t = 2.0 * (step + 1)
        n_done = min(2 + step, len(port_win.jobs))
        end = int(port_win.starts[n_done - 1]) + port_win.jobs[n_done - 1].ntasks if n_done else 0
        tf = np.full(port_win.T_cap, np.inf, np.float32)
        tf[:end] = t - 0.5
        tf[end : end + 3] = t + 1.0          # a running job keeps its slots
        ref_state = ref_state.replace(task_finish=jax.numpy.asarray(tf),
                                      t=jax.numpy.float32(t))
        port_state = port_state.replace(task_finish=torch.from_numpy(tf)[None],
                                        t=torch.tensor([t], dtype=torch.float32))
        head = int(np.asarray(getattr(ref_state, "probe_head", 0)))
        ref_state, ref_stats, _ = ref_win.refill(ref_state)
        port_state, port_stats, _ = port_win.refill(port_state, t, 0, head)
        assert ref_stats == port_stats
        _assert_layouts_equal(ref_win, port_win, rule)
        for f in dataclasses.fields(port_state):
            r = np.asarray(getattr(ref_state, f.name))
            g = getattr(port_state, f.name)[0].numpy()
            assert np.array_equal(r, g), (step, f.name)


# ---------------------------------------------------------------------------
# the reference's own pins, held against the port's fixed path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fixed(rule: str):
    kw = {}
    if rule == "megha":
        kw["orders"] = _ref_orders(FULL["window_tasks"])
    return simulate_workload(rule, synth.synthetic_trace(**_TRACE), W, num_gms=GMS,
                             num_lms=LMS, device="cpu", **kw)


@pytest.mark.parametrize("rule", RULES)
def test_stream_matches_the_fixed_path(rule):
    """The full-capacity window IS the fixed trace: every task completes,
    nothing is lost, and for the deterministic rules the sorted delays are
    the port's fixed path's (the probe rules draw their targets elsewhere,
    so their percentiles agree within the reference's tolerance)."""
    fixed, run = _fixed(rule), _port_run(rule, "full")
    wl = synth.synthetic_trace(**_TRACE)
    assert run.tasks_admitted == run.tasks_completed == fixed.tasks_completed == wl.num_tasks
    assert run.jobs_completed == run.jobs_admitted == wl.num_jobs
    assert run.lost == fixed.lost_tasks == 0
    fd = fixed.job_delays()
    fd = fd[np.isfinite(fd)]
    sd = run.delays
    assert sd.shape == fd.shape
    if rule in EXACT:
        np.testing.assert_allclose(np.sort(sd), np.sort(fd), atol=1e-5)
    else:
        f50, f95 = np.percentile(fd, 50), np.percentile(fd, 95)
        s50, s95 = np.percentile(sd, 50), np.percentile(sd, 95)
        assert s50 <= 2.0 * f50 + 0.05 and f50 <= 2.0 * s50 + 0.05
        assert abs(s95 - f95) <= 0.35 * max(f95, s95) + 0.05


@pytest.mark.parametrize("rule", RULES)
def test_small_window_conserves_and_drains(rule):
    """At every refill the admitted stream partitions exactly (admitted =
    completed + running + pending + unarrived + lost), the window recycles
    at least 8 times, and the stream drains with nothing lost."""
    run = _port_run(rule, "small")
    assert len(run.refills) >= 8
    for s in run.refills:
        assert s["admitted"] == (s["completed"] + s["running"] + s["pending"]
                                 + s["unarrived"] + s["lost"]), s
        assert s["window_jobs"] <= 8
    wl = synth.synthetic_trace(**_TRACE)
    assert run.tasks_completed == wl.num_tasks
    assert run.jobs_completed == wl.num_jobs
    assert run.lost == 0
    exact = np.quantile(run.delays, 0.5)
    spread = float(run.delays.max() - run.delays.min())
    assert abs(run.quantile(0.5) - exact) <= 0.25 * spread + 1e-6


def test_stream_determinism():
    """Same seed, bitwise the same run: delays, counters, every series and
    the refills."""
    def go():
        arr = synth.PoissonArrivals(rate=4.0, job_factory=synth.bimodal_job_factory(),
                                    seed=11, num_jobs=24)
        return stream.run_steady_state("sparrow", arr, W, window_jobs=8, window_tasks=128,
                                       rounds_per_refill=16, device="cpu", **COMMON)
    a, b = go(), go()
    assert np.array_equal(a.delays, b.delays)
    assert (a.tasks_completed, a.probes, a.messages) == (b.tasks_completed, b.probes, b.messages)
    for k in a.series:
        assert np.array_equal(a.series[k], b.series[k], equal_nan=True), k
    assert a.refills == b.refills


@pytest.mark.parametrize("rule", ["oracle", "megha", "pigeon"])
def test_state_bytes_independent_of_span(rule):
    """The O(W + window) claim, measured: double the simulated trace and
    the carried device footprint (state, window arrays, layout, sketch)
    does not change by a byte."""
    long_wl = synth.synthetic_trace(**dict(_TRACE, num_jobs=120))
    kw = dict(SMALL, **COMMON)
    if rule == "megha":
        kw["orders"] = _ref_orders(SMALL["window_tasks"])
    long_run = stream.run_steady_state(rule, synth.ReplayArrivals(long_wl), W, device="cpu",
                                       **kw)
    short = _port_run(rule, "small")
    assert long_run.tasks_completed == long_wl.num_tasks
    assert long_run.state_bytes == short.state_bytes
    if rule == "oracle":
        assert short.state_bytes < 64 * 1024


# ---------------------------------------------------------------------------
# refusals and plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["megha", "sparrow", "eagle", "pigeon"])
def test_layout_with_faults_raises_the_reference_error(rule):
    cfg = stream.stream_config(rule, W, window_tasks=80, num_gms=GMS, num_lms=LMS)
    win = stream._StreamWindow(_arrivals(synth, "replay"), cfg, rule, 8, 80, 0,
                               torch.device("cpu"))
    tasks = win.tasks()
    faults = empty_schedule(cfg.num_workers, cfg.num_gms)
    build = {
        "megha": lambda: megha.make_megha_step(cfg, tasks, _ref_orders(80), faults=faults,
                                               layout=win.layout()),
        "sparrow": lambda: sparrow.make_sparrow_step(cfg, tasks, None, faults=faults,
                                                     layout=win.layout()),
        "eagle": lambda: eagle.make_eagle_step(cfg, tasks, None, faults=faults,
                                               layout=win.layout()),
        "pigeon": lambda: pigeon.make_pigeon_step(cfg, tasks, faults=faults,
                                                  layout=win.layout()),
    }[rule]
    with pytest.raises(NotImplementedError,
                       match="streaming layout does not compose with fault schedules"):
        build()


def test_stream_defaults_to_the_card():
    """``device=None`` is the CUDA card; without one the run raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.run_steady_state("oracle", _arrivals(synth, "replay"), W, **SMALL, **COMMON)


def test_stream_refuses_draws_for_rules_that_draw_at_admission():
    with pytest.raises(ValueError, match="pass no draws"):
        stream.run_steady_state("sparrow", _arrivals(synth, "replay"), W, device="cpu",
                                draws={"targets": torch.zeros(1)}, **SMALL, **COMMON)


def test_megha_stream_seeded_orders_are_deterministic():
    """Without fed-in orders megha draws its GM orders from the seed: the
    run is reproducible and completes the stream."""
    kw = dict(SMALL, **COMMON)
    a = stream.run_steady_state("megha", _arrivals(synth, "replay"), W, device="cpu", **kw)
    b = stream.run_steady_state("megha", _arrivals(synth, "replay"), W, device="cpu", **kw)
    assert np.array_equal(a.delays, b.delays) and a.refills == b.refills
    assert a.tasks_completed == synth.synthetic_trace(**_TRACE).num_tasks


def test_sketch_lives_on_the_given_device_and_matches_the_reference_stream():
    """``sketch_init(device=)`` puts every tensor there; the plain absorb of
    a seeded stream, through the kernel wrapper on the CPU, is bitwise the
    plain version's."""
    from repro_torch.kernels import p2

    sk = tlm.sketch_init(device="cpu")
    assert all(t.device.type == "cpu" for t in (sk.q, sk.n, sk.npd, sk.dn, sk.buf, sk.count))
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.lognormal(0.0, 0.5, 300).astype(np.float32))
    mask = torch.from_numpy(rng.random(300) < 0.7)
    a = p2.p2_absorb(sk, vals, mask)
    b = tlm.sketch_absorb(sk, vals, mask)
    for f in ("q", "n", "npd", "buf", "count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert p2.p2_absorb.launches == 0
