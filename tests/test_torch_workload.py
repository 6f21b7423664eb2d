"""The port's copies of the reference's framework-free pieces (workload
generators, trace export, metrics helpers, shared constants) give the
reference's results."""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import base as jax_base
from repro.core import megha as jax_core_megha
from repro.core import metrics as jax_metrics
from repro.simx import export_workload as jax_export_workload
from repro.workload import synth as jax_synth
from repro_torch.core import base, metrics
from repro_torch.simx import convert
from repro_torch.simx.state import export_workload
from repro_torch.workload import synth


def _jobs(wl):
    return [
        (j.job_id, j.submit_time, list(j.durations), j.estimated_duration)
        for j in wl.jobs
    ]


TRACES = {
    "synthetic": lambda m: m.synthetic_trace(
        num_jobs=40, tasks_per_job=64, load=0.8, num_workers=256, seed=7),
    "synthetic_fixed": lambda m: m.synthetic_trace(
        num_jobs=12, tasks_per_job=8, load=0.5, num_workers=64, seed=1,
        arrivals="fixed"),
    "yahoo_like": lambda m: m.yahoo_like_trace(
        num_jobs=300, total_tasks=9000, num_workers=1000, seed=4),
    "google_like": lambda m: m.google_like_trace(
        num_jobs=200, total_tasks=6000, num_workers=1000, seed=5),
    "downsampled": lambda m: m.downsampled(
        m.yahoo_like_trace(num_jobs=500, total_tasks=20000, seed=6),
        factor=10, max_jobs=30),
}


@pytest.mark.parametrize("trace", list(TRACES))
def test_generators_match_reference(trace):
    ours, theirs = TRACES[trace](synth), TRACES[trace](jax_synth)
    assert ours.name == theirs.name
    assert _jobs(ours) == _jobs(theirs)
    assert ours.stats() == theirs.stats()


@pytest.mark.parametrize("trace", list(TRACES))
def test_export_workload_matches_reference(trace):
    ours = convert.state_to_numpy(export_workload(TRACES[trace](synth), "cpu"))
    theirs = jax_export_workload(TRACES[trace](jax_synth))
    for f in dataclasses.fields(theirs):
        want = np.asarray(getattr(theirs, f.name))
        assert ours[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(ours[f.name], want, err_msg=f.name)


def test_percentile_and_classify_long_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = rng.exponential(size=n).tolist()
        for p in (0, 5, 50, 95, 99.9, 100):
            a, b = metrics.percentile(xs, p), jax_metrics.percentile(xs, p)
            assert a == b or (math.isnan(a) and math.isnan(b))
    for d in (0.0, 9.99, 10.0, 45.0):
        assert metrics.classify_long(d, 10.0) == jax_metrics.classify_long(d, 10.0)


def test_shared_constants_match_reference():
    assert base.LONG_JOB_THRESHOLD == jax_base.LONG_JOB_THRESHOLD
    for w, g, l in [(256, 4, 4), (50_000, 8, 8), (1000, 8, 8), (63, 2, 4)]:
        assert base.grid_workers(w, g, l) == jax_core_megha.grid_workers(w, g, l)


#: the open-loop arrival processes of the streaming engine, with each job
#: factory; ``num_jobs`` bounds some, a horizon bounds the open-ended ones
#: (MMPP's defaults stay clear of the reference's failing equal-rates
#: configuration, ROADMAP queue 3)
ARRIVALS = {
    "poisson_fixed": lambda m: m.PoissonArrivals(
        rate=40.0, job_factory=m.fixed_job_factory(1000, 1.0), seed=7, num_jobs=50),
    "poisson_bimodal": lambda m: m.PoissonArrivals(
        rate=4.0, job_factory=m.bimodal_job_factory(), seed=11, num_jobs=40),
    "poisson_open": lambda m: m.PoissonArrivals(
        rate=2.5, job_factory=m.bimodal_job_factory(8, 0.3, 0.4, 30.0), seed=3),
    "mmpp": lambda m: m.MMPPArrivals(
        job_factory=m.bimodal_job_factory(), seed=2, num_jobs=80),
    "mmpp_three_regimes": lambda m: m.MMPPArrivals(
        rates=(1.0, 8.0, 3.0), dwell=(5.0, 2.0, 4.0), seed=9),
    "diurnal": lambda m: m.DiurnalArrivals(
        base_rate=3.0, amplitude=0.7, period=30.0, seed=4, num_jobs=60),
    "phased": lambda m: m.PhasedArrivals(
        [(10.0, 2.0), (5.0, 12.0), (20.0, 1.0)], seed=6),
    "phased_cycle": lambda m: m.PhasedArrivals(
        [(4.0, 5.0), (2.0, 15.0)], cycle=True, seed=8, num_jobs=70),
    "replay": lambda m: m.ReplayArrivals(m.synthetic_trace(
        num_jobs=30, tasks_per_job=8, load=0.7, num_workers=128, seed=3)),
}
HORIZON = 60.0


def _stream(proc, horizon: float = HORIZON) -> list:
    out = []
    for j in proc.jobs():
        if j.submit_time > horizon:
            break
        out.append((j.job_id, j.submit_time, list(j.durations), j.estimated_duration))
    return out


@pytest.mark.parametrize("name", list(ARRIVALS))
def test_arrival_processes_match_reference(name):
    """Every arrival process gives the reference's job stream job for job
    (ids, submit times, durations, estimates), to its ``num_jobs`` or to a
    horizon, restartably; and the same rates and offered load."""
    ours, theirs = ARRIVALS[name](synth), ARRIVALS[name](jax_synth)
    a = _stream(ours)
    assert a and a == _stream(theirs)
    assert a == _stream(ours)                       # jobs() restarts
    if ours.num_jobs is not None:
        assert len(_stream(ours, math.inf)) == ours.num_jobs
    assert ours.mean_rate == theirs.mean_rate
    assert ours.mean_job_demand() == theirs.mean_job_demand()
    assert ours.offered_load(1000) == theirs.offered_load(1000)
    assert ours.name == theirs.name


@pytest.mark.parametrize("factory", ["fixed", "bimodal", "bimodal_custom"])
def test_job_factories_match_reference(factory):
    make = {
        "fixed": lambda m: m.fixed_job_factory(12, 0.5),
        "bimodal": lambda m: m.bimodal_job_factory(),
        "bimodal_custom": lambda m: m.bimodal_job_factory(5, 0.5, 1.0, 20.0),
    }[factory]
    ours, theirs = make(synth), make(jax_synth)
    import random

    r1, r2 = random.Random(17), random.Random(17)
    for i in range(50):
        assert list(ours(r1, i)) == list(theirs(r2, i))


def test_arrival_processes_refuse_what_the_reference_refuses():
    for bad in (
        lambda m: m.PoissonArrivals(rate=0.0),
        lambda m: m.MMPPArrivals(rates=(1.0,), dwell=(1.0, 2.0)),
        lambda m: m.MMPPArrivals(rates=(1.0, -1.0), dwell=(1.0, 2.0)),
        lambda m: m.DiurnalArrivals(base_rate=1.0, amplitude=1.0),
        lambda m: m.PhasedArrivals([]),
    ):
        for m in (synth, jax_synth):
            with pytest.raises(ValueError):
                bad(m)
