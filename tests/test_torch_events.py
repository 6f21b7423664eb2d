"""The port's event backend (``repro_torch.core.{events,base,megha}`` and
``core.baselines`` behind ``run_simulation(..., backend="events")``) against
the JAX package's, record for record: every task's times and delay
components, every job record and every counter, on small synthetic and
google-like traces built by each package's own copy of the generators, for
megha, sparrow, eagle and pigeon."""

import dataclasses
import math

import pytest

from repro.core import baselines as jax_baselines
from repro.core import megha as jax_megha
from repro.core.events import NETWORK_DELAY as JAX_NETWORK_DELAY
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.workload import synth as jax_synth
from repro_torch.core import base, baselines, megha
from repro_torch.core.events import NETWORK_DELAY, EventLoop
from repro_torch.sim.simulator import run_simulation
from repro_torch.simx import FaultPlan, GmOutage, WorkerFailure
from repro_torch.workload import synth

TRACES = {
    "light": dict(num_jobs=12, tasks_per_job=24, load=0.5, num_workers=256, seed=2),
    "heavy": dict(num_jobs=20, tasks_per_job=64, load=0.95, num_workers=256, seed=7),
}
CONFIGS = {
    "default": {},
    "fast_heartbeat": dict(num_gms=4, num_lms=4, heartbeat_interval=0.5, batch_limit=8),
}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _assert_records_equal(got, want) -> None:
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert _same(a, b), (f.name, a, b)


def _assert_runs_equal(got, want) -> None:
    assert len(got.tasks) == len(want.tasks) > 0
    assert len(got.jobs) == len(want.jobs) > 0
    for a, b in zip(got.tasks, want.tasks):
        _assert_records_equal(a, b)
    for a, b in zip(got.jobs, want.jobs):
        _assert_records_equal(a, b)
    for counter in ("inconsistencies", "repartitions", "messages", "probes"):
        assert getattr(got, counter) == getattr(want, counter), counter
    assert (got.scheduler, got.workload) == (want.scheduler, want.workload)
    s, t = got.summary(), want.summary()
    assert s.keys() == t.keys() and all(_same(s[k], t[k]) for k in t)
    assert all(tr.finish_time == tr.finish_time for tr in got.tasks)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("trace", list(TRACES))
def test_megha_events_match_reference_record_for_record(trace, config):
    kw = CONFIGS[config]
    got = run_simulation("megha", synth.synthetic_trace(**TRACES[trace]), num_workers=256, **kw)
    want = jax_run_simulation("megha", jax_synth.synthetic_trace(**TRACES[trace]),
                              num_workers=256, **kw)
    _assert_runs_equal(got, want)


#: the baselines' configs: their defaults and every knob moved
BASELINE_CONFIGS = {
    "sparrow": {"default": {}, "tuned": dict(num_schedulers=3, probe_ratio=3, seed=4)},
    "eagle": {"default": {}, "tuned": dict(num_schedulers=4, probe_ratio=3,
                                           short_partition_fraction=0.2, long_threshold=8.0,
                                           seed=2)},
    "pigeon": {"default": {}, "tuned": dict(num_distributors=3, group_size=24,
                                            reserved_per_group=3, weight=2,
                                            long_threshold=8.0)},
}
#: a trace with long jobs (eagle's central scheduler, pigeon's low queue)
GOOGLE = dict(num_jobs=60, total_tasks=1500, num_workers=256, seed=2)


def _baseline_trace(trace: str, m):
    return m.google_like_trace(**GOOGLE) if trace == "google" else \
        m.synthetic_trace(**TRACES[trace])


@pytest.mark.parametrize("config", ["default", "tuned"])
@pytest.mark.parametrize("trace", list(TRACES) + ["google"])
@pytest.mark.parametrize("name", list(BASELINE_CONFIGS))
def test_baseline_events_match_reference_record_for_record(name, trace, config):
    kw = BASELINE_CONFIGS[name][config]
    got = run_simulation(name, _baseline_trace(trace, synth), num_workers=256, **kw)
    want = jax_run_simulation(name, _baseline_trace(trace, jax_synth), num_workers=256, **kw)
    _assert_runs_equal(got, want)
    assert got.scheduler == name


def test_baseline_configs_are_copies():
    for name in ("Sparrow", "Eagle", "Pigeon"):
        ours = getattr(baselines, f"{name}Config")(num_workers=256)
        theirs = getattr(jax_baselines, f"{name}Config")(num_workers=256)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert baselines.EagleConfig(num_workers=1000).short_reserved == \
        jax_baselines.EagleConfig(num_workers=1000).short_reserved
    assert baselines.PigeonConfig(num_workers=1000).num_groups == \
        jax_baselines.PigeonConfig(num_workers=1000).num_groups


def test_events_until_and_max_events_stop_like_reference():
    wl = TRACES["heavy"]
    for stop in (dict(until=0.5), dict(max_events=300)):
        got = run_simulation("megha", synth.synthetic_trace(**wl), num_workers=256, **stop)
        want = jax_run_simulation("megha", jax_synth.synthetic_trace(**wl), num_workers=256,
                                  **stop)
        assert sum(t.finish_time == t.finish_time for t in got.tasks) == \
            sum(t.finish_time == t.finish_time for t in want.tasks)
        assert (got.messages, got.inconsistencies) == (want.messages, want.inconsistencies)


def test_events_hooks_run_on_the_loop():
    seen = []
    run_simulation("megha", synth.synthetic_trace(**TRACES["light"]), num_workers=256,
                   hooks=lambda sched, loop: seen.append((sched.name, type(loop).__name__)))
    assert seen == [("megha", "EventLoop")]


def test_copies_match_reference():
    assert NETWORK_DELAY == JAX_NETWORK_DELAY
    for n, g, l in ((50_000, 8, 8), (256, 4, 4), (1000, 3, 7)):
        assert base.grid_workers(n, g, l) == jax_megha.grid_workers(n, g, l)
    cfg, jcfg = megha.MeghaConfig(num_workers=256), jax_megha.MeghaConfig(num_workers=256)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [cfg.partition_gm_of(w) for w in range(256)] == \
        [jcfg.partition_gm_of(w) for w in range(256)]


def test_event_loop_orders_ties_by_insertion():
    loop, fired = EventLoop(), []
    for i in range(5):
        loop.push(1.0, lambda i=i: fired.append(i))
    ev = loop.push(0.5, lambda: fired.append("cancelled"))
    EventLoop.cancel(ev)
    loop.run()
    assert fired == [0, 1, 2, 3, 4] and loop.now == 1.0 and loop.empty()
    with pytest.raises(ValueError):
        loop.push(-1.0, lambda: None)


def test_events_refuse_faults_and_unknown_names():
    """A ``FaultPlan`` drives megha's hooks on the event backend (every job
    finishes, and the crash is paid for); anything without
    ``install_events`` is refused, as are unknown names."""
    wl = synth.synthetic_trace(num_jobs=2, tasks_per_job=4, num_workers=64, seed=0)
    plan = FaultPlan(worker_failures=(WorkerFailure(0, 0.01),),
                     gm_outages=(GmOutage(1, 0.0, 0.5),))
    m = run_simulation("megha", wl, 64, num_gms=2, num_lms=2, faults=plan)
    assert len(m.job_delays()) == 2 and all(t.finish_time == t.finish_time for t in m.tasks)
    with pytest.raises(ValueError, match="FaultPlan"):
        run_simulation("megha", wl, 64, faults=object())
    with pytest.raises(ValueError, match="unknown scheduler"):
        run_simulation("nope", wl, 64)
    with pytest.raises(ValueError, match="unknown backend"):
        run_simulation("megha", wl, 64, backend="nope")
