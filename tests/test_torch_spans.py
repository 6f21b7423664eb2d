"""The port's span-and-counter recorder (``repro_torch.simx.spans``) on the
Fig. 2 round path, and the benchmark's readers of it
(``portbench/program_spans.py``, ``portbench/metrics/{sync_wait_ms,
loop_idle_ms,step_idle_ms,borrow_kept_share}.py``), on the CPU.

Recording is off by default and changes no result; under the profiler a
round records one ``simx.round`` whose stages nest inside it on the
profiler's own clock; the borrow counters agree with the step's.  The
readers are held on synthetic spans and device events."""

import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.simx import fig2_plan, runtime, spans, sweep

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, program_spans  # noqa: E402

#: the slack allowed between a span and the profiler's events it encloses
CLOCK_SLACK_NS = 50_000
READERS = ("sync_wait_ms", "loop_idle_ms", "step_idle_ms", "borrow_kept_share")


def _grid(rule: str, match_fn=None):
    """A B = 2 grid (two loads, one seed) with every job queued at once, 3
    tasks a worker, so that megha's queues outrun its GMs' own partitions
    and it borrows: ``(step, state, point tasks)``."""
    plan = fig2_plan(rule, loads=(0.6, 0.95), num_seeds=1, num_workers=512, num_jobs=24,
                     tasks_per_job=64, device="cpu")
    return sweep.build_grid(
        plan.name, plan.cfg, plan.tasks, torch.zeros_like(plan.submit_grid),
        torch.zeros_like(plan.job_submit_grid), plan.seeds,
        match_fn=match_fn or plan.match_fn, draws=plan.draws)


def _fields(state) -> dict:
    return {k: v for k, v in vars(state).items() if isinstance(v, torch.Tensor)}


@pytest.fixture(autouse=True)
def _fresh():
    """Every test starts and ends with nothing recorded."""
    spans.take()
    yield
    spans.take()


@pytest.mark.parametrize("rule", ["megha", "sparrow"])
def test_off_by_default_and_a_session_changes_no_state(rule):
    step, state, _ = _grid(rule)
    off = runtime.scan_rounds(step, state, 6)
    assert not spans.take().spans
    step2, state2, _ = _grid(rule)
    with spans.session() as rec:
        on = runtime.scan_rounds(step2, state2, 6)
    assert [s.name for s in rec.spans].count("simx.round") == 6
    a, b = _fields(off), _fields(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not spans.take().spans


def test_the_off_span_is_one_shared_object():
    assert spans.span("a") is spans.span("b", read=True) is spans._OFF
    with spans.span("a") as s:
        assert s is None
    spans.count("a", 1)
    assert not spans.take().counters


@pytest.mark.parametrize("rule", ["megha", "sparrow"])
def test_under_the_profiler_rounds_nest_and_share_their_index(rule):
    step, state, _ = _grid(rule)
    runtime.scan_rounds(step, state, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        runtime.scan_rounds(step, state, 4)
    rec = spans.take()
    assert not spans.take().spans
    rounds = [s for s in rec.spans if s.name == "simx.round"]
    assert [s.round for s in rounds] == [0, 1, 2, 3]
    stages = {"megha": ("megha.heartbeat", "megha.internal_match", "megha.borrow", "megha.head"),
              "sparrow": ("sparrow.compact", "sparrow.insert", "sparrow.bind")}[rule]
    names = {s.name for s in rec.spans}
    assert names >= {"simx.faults", "simx.complete", "simx.dispatch", "simx.advance", *stages}
    for s in rec.spans:
        assert s.end is not None and s.start <= s.end
        if s.name == "simx.round":
            assert s.parent is None
            continue
        assert s.parent is not None and s.round == s.parent.round
        assert s.parent.start <= s.start and s.end <= s.parent.end
        assert s.inside("simx.round")
    for name in stages:
        assert [s.round for s in rec.spans if s.name == name] == [0, 1, 2, 3]
        assert all(s.parent.name == "simx.dispatch" for s in rec.spans if s.name == name)


def test_internal_match_span_encloses_its_ops_on_the_profilers_clock():
    """The match function issues one marker op (``aten::gcd``) a call: the
    internal match's call lies inside that round's ``megha.internal_match``
    span, and each borrow round's inside its ``megha.borrow`` span."""
    plain = runtime.default_match_fn(False)

    def marked(avail, n):
        torch.gcd(n, n)
        return plain(avail, n)

    step, state, _ = _grid("megha", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runtime.scan_rounds(step, state, 4)
    rec = spans.take()
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() == "aten::gcd")
    borrows = rec.counters["megha.borrow_rounds"]
    assert borrows >= 1 and len(marks) == 4 + borrows
    for name in ("megha.internal_match", "megha.borrow"):
        for s in (s for s in rec.spans if s.name == name):
            inside = [m for m in marks if s.start - CLOCK_SLACK_NS <= m[0] <= s.end]
            assert len(inside) <= 1
            if name == "megha.internal_match":
                assert len(inside) == 1
            for a, b in inside:
                assert b <= s.end + CLOCK_SLACK_NS


def test_take_returns_what_the_profiler_recorded_and_clears_it():
    step, state, _ = _grid("megha")
    runtime.scan_rounds(step, state, 2)
    assert not spans.take().spans and not spans.take().counters
    with profile(activities=[ProfilerActivity.CPU]):
        runtime.scan_rounds(step, state, 2)
    runtime.scan_rounds(step, state, 2)
    rec = spans.take()
    assert rec.closed and [s.round for s in rec.spans if s.name == "simx.round"] == [0, 1]
    again = spans.take()
    assert not again.spans and not again.counters


def test_borrow_points_sum_to_the_steps_per_point_counter():
    step, state, _ = _grid("megha")
    state = runtime.scan_rounds(step, state, 1)
    before_rounds = step.borrow_rounds
    before = (step.point_borrow_rounds.clone() if step.point_borrow_rounds is not None
              else torch.zeros(2, dtype=torch.int32))
    with spans.session() as rec:
        runtime.scan_rounds(step, state, 5)
    assert rec.counters["megha.borrow_rounds"] == step.borrow_rounds - before_rounds >= 1
    assert rec.counters["megha.borrow_points"] == int((step.point_borrow_rounds - before).sum())
    assert rec.counter_items["megha.borrow_points"] == 2 * rec.counters["megha.borrow_rounds"]
    checks = [s for s in rec.spans if s.name == "megha.borrow_check"]
    assert len(checks) == 5 and all(s.read and s.parent.name == "megha.borrow" for s in checks)


def test_session_table_gives_count_total_and_self_time():
    step, state, point_tasks = _grid("sparrow")
    with spans.session() as rec:
        out = sweep.point_summary(runtime.scan_rounds(step, state, 3), point_tasks)
    assert out["tasks_done"].shape == (2,)
    table = rec.table()
    assert table["simx.round"]["count"] == 3 and table["sweep.point_summary"]["count"] == 1
    for row in table.values():
        assert 0.0 <= row["self_ms"] <= row["total_ms"] + 1e-9
    children = sum(table[n]["total_ms"] for n in
                   ("simx.faults", "simx.complete", "simx.dispatch", "simx.advance"))
    r = table["simx.round"]
    assert r["self_ms"] == pytest.approx(r["total_ms"] - children, abs=1e-6)


def test_a_record_drops_spans_past_its_cap(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 3)
    with spans.session() as rec:
        for _ in range(5):
            with spans.span("x"):
                spans.count("c", 1)
    assert len(rec.spans) == 3 and rec.counters["c"] == 3 and rec.dropped == 4


# -- the readers, on synthetic spans and device events -----------------------

_T0 = 1_700_000_000_000_000_000   # a Unix time in ns, as the profiler's
#: seconds since 1970 as a float resolve 0.24 us: a few such steps of slack
US = 1e-6


def _span(name, a_us, b_us, parent=None, read=False, rnd=0):
    s = spans.Span(name, parent, rnd, read)
    s.start, s.end = _T0 + int(a_us * 1e3), _T0 + int(b_us * 1e3)
    return s


def _synthetic():
    """Two rounds: round r at [1000 r, 1000 r + 900] us, dispatch in it at
    [100, 700], a borrow stage [300, 600] with a read [400, 500]."""
    out = []
    for r in range(2):
        o = 1000 * r
        rnd = _span("simx.round", o, o + 900, rnd=r)
        disp = _span("simx.dispatch", o + 100, o + 700, rnd, rnd=r)
        bor = _span("megha.borrow", o + 300, o + 600, disp, rnd=r)
        chk = _span("megha.borrow_check", o + 400, o + 500, bor, read=True, rnd=r)
        out += [rnd, _span("simx.complete", o + 10, o + 90, rnd, rnd=r), disp,
                _span("megha.internal_match", o + 110, o + 290, disp, rnd=r), bor, chk,
                _span("simx.advance", o + 710, o + 890, rnd, rnd=r)]
    return out


def _dev(*intervals_us):
    return [("k", (_T0 * 1e-9) + a * 1e-6, (_T0 * 1e-9) + b * 1e-6) for a, b in intervals_us]


def _ctx(span_list, device, counters=None, items=None, on_card=True, host=()):
    rec = spans.Record()
    rec.spans = span_list
    rec.counters, rec.counter_items, rec.closed = counters or {}, items or {}, True
    return dict(program_spans=rec, device=device, host=list(host), stretch_rounds=2,
                on_card=on_card)


def _read(name, ctx):
    return harness._load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name).read(ctx)


def test_readers_attribute_each_gap_to_the_innermost_span():
    # gaps (us): [20, 50] mid in simx.complete -> loop; [150, 200] mid in
    # internal_match (inside dispatch) -> step; [420, 560] starts in the
    # read -> loop though its midpoint is in megha.borrow; [620, 680] mid in
    # dispatch itself -> step; [950, 1040] between rounds -> loop; [1350,
    # 1380] in round 1's borrow stage, before its read -> step
    busy = ((0, 20), (50, 150), (200, 420), (560, 620), (680, 950), (1040, 1350),
            (1380, 1900))
    ctx = _ctx(_synthetic(), _dev(*busy))
    step_s, loop_s, by = program_spans.idle_split(ctx)
    assert step_s == pytest.approx((50 + 60 + 30) * 1e-6, abs=US)
    assert loop_s == pytest.approx((30 + 140 + 90) * 1e-6, abs=US)
    assert by == pytest.approx({"simx.complete": 30e-6, "megha.internal_match": 50e-6,
                                "megha.borrow_check": 140e-6, "simx.dispatch": 60e-6,
                                program_spans.NO_SPAN: 90e-6, "megha.borrow": 30e-6}, abs=US)
    step_ms, loop_ms = _read("step_idle_ms", ctx), _read("loop_idle_ms", ctx)
    assert step_ms == 1e3 * step_s / 2 and loop_ms == 1e3 * loop_s / 2
    # the two make up the idle between the first and the last device op
    idle_us = 1900 - sum(b - a for a, b in busy)
    assert (step_ms + loop_ms) * 2 == pytest.approx(idle_us * 1e-3, abs=1e-3 * US / 1e-6)
    # overlapping device intervals leave no gap between them
    gaps = program_spans.idle_gaps(_dev((0, 10), (5, 30), (40, 50)))
    assert len(gaps) == 1 and gaps[0][1] - gaps[0][0] == pytest.approx(10e-6, abs=US)


def test_device_events_early_against_their_launches_are_put_back():
    """The profiler's device clock off by -300 us: paired in order with the
    host's launch calls, each 5 us before its operation, the split is the
    one of the true times; without launch calls to pair, nothing moves."""
    busy = ((0, 20), (50, 150), (200, 420), (560, 620), (680, 950), (1040, 1350),
            (1380, 1900))
    launches = [("cudaLaunchKernel", (_T0 * 1e-9) + (a - 5) * 1e-6, (_T0 * 1e-9) + a * 1e-6)
                for a, _ in busy]
    early = _dev(*((a - 300, b - 300) for a, b in busy))
    true = program_spans.idle_split(_ctx(_synthetic(), _dev(*busy)))
    ctx = _ctx(_synthetic(), early, host=launches + [("aten::add", 0.0, 1.0)])
    # the shift that starts the least-lagging operation at its launch call
    assert program_spans.device_offset(ctx) == pytest.approx(295e-6, abs=US)
    fixed = program_spans.idle_split(ctx)
    assert fixed[0] == pytest.approx(true[0], abs=US) and fixed[1] == pytest.approx(true[1], abs=US)
    # device events late or on time, or launches that do not pair: no shift
    assert program_spans.device_offset(_ctx(_synthetic(), _dev(*busy), host=launches)) == 0.0
    assert program_spans.device_offset(_ctx(_synthetic(), early, host=launches[1:])) == 0.0


def test_sync_wait_and_borrow_kept_share():
    ctx = _ctx(_synthetic(), _dev((0, 10)),
               counters={"megha.borrow_rounds": 2, "megha.borrow_points": 3},
               items={"megha.borrow_rounds": 2, "megha.borrow_points": 4 * 2})
    assert _read("sync_wait_ms", ctx) == pytest.approx(0.1)      # 2 x 100 us over 2 rounds
    assert _read("borrow_kept_share", ctx) == pytest.approx(100.0 * 3 / 8)
    quiet = _ctx([s for s in _synthetic() if not s.read], _dev((0, 10)))
    assert _read("sync_wait_ms", quiet) == 0.0
    assert _read("borrow_kept_share", quiet) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_off_the_card_or_without_the_recorder(name, monkeypatch):
    assert _read(name, _ctx(_synthetic(), _dev((0, 10)), on_card=False)) is None
    assert _read(name, _ctx([], _dev((0, 10)))) is None
    # a program without the recorder: the import fails, nothing is raised
    monkeypatch.setitem(sys.modules, "repro_torch.simx.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch.simx"], "spans")
    ctx = dict(device=_dev((0, 10)), stretch_rounds=2, on_card=True)
    assert _read(name, ctx) is None and ctx["program_spans"] is None


def test_the_first_reader_takes_the_record_for_the_others():
    step, state, _ = _grid("megha")
    with profile(activities=[ProfilerActivity.CPU]):
        runtime.scan_rounds(step, state, 2)
    ctx = dict(device=_dev((0, 10)), stretch_rounds=2, on_card=True)
    rec = program_spans.record(ctx)
    assert rec is not None and [s.round for s in rec.spans if s.name == "simx.round"] == [0, 1]
    assert program_spans.record(ctx) is rec and not spans.take().spans


def test_an_off_span_site_costs_a_few_microseconds_at_most():
    """A bound generous enough for a loaded test machine; PERF.md gives the
    measured cost (under a microsecond)."""
    n = 20_000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with spans.span("megha.internal_match"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 5e-6
