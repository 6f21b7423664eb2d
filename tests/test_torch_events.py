"""The port's event backend (``repro_torch.core.{events,base,megha}`` behind
``run_simulation(..., backend="events")``) against the JAX package's, record
for record: every task's times and delay components, every job record and
every counter, on small synthetic traces built by each package's own copy of
``synthetic_trace``."""

import dataclasses
import math

import pytest

from repro.core import megha as jax_megha
from repro.core.events import NETWORK_DELAY as JAX_NETWORK_DELAY
from repro.sim.simulator import run_simulation as jax_run_simulation
from repro.workload import synth as jax_synth
from repro_torch.core import base, megha
from repro_torch.core.events import NETWORK_DELAY, EventLoop
from repro_torch.sim.simulator import run_simulation
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


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("trace", list(TRACES))
def test_megha_events_match_reference_record_for_record(trace, config):
    kw = CONFIGS[config]
    got = run_simulation("megha", synth.synthetic_trace(**TRACES[trace]), num_workers=256, **kw)
    want = jax_run_simulation("megha", jax_synth.synthetic_trace(**TRACES[trace]),
                              num_workers=256, **kw)
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


@pytest.mark.parametrize("name", ["sparrow", "eagle", "pigeon"])
def test_events_baselines_refuse_until_ported(name):
    wl = synth.synthetic_trace(num_jobs=2, tasks_per_job=4, num_workers=64, seed=0)
    with pytest.raises(NotImplementedError, match="items 8-9"):
        run_simulation(name, wl, 64)


def test_events_refuse_faults_and_unknown_names():
    wl = synth.synthetic_trace(num_jobs=2, tasks_per_job=4, num_workers=64, seed=0)
    with pytest.raises(NotImplementedError, match="item 7"):
        run_simulation("megha", wl, 64, faults=object())
    with pytest.raises(ValueError, match="unknown scheduler"):
        run_simulation("nope", wl, 64)
    with pytest.raises(ValueError, match="unknown backend"):
        run_simulation("megha", wl, 64, backend="nope")
