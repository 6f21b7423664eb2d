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
