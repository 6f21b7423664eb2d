"""The port on a CUDA card: the hand-written kernels against their plain
versions, and small runs of all five simx rules, Fig. 2 grids and
serving-engine runs on the card against the same runs on the CPU, with
the telemetry and provenance stages on too, and a train step and a
checkpoint of card tensors.  Every test here carries the ``gpu`` marker and skips itself
without a card.  This file imports no ``jax`` (the card's machine has
none); run it there with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import random

import numpy as np
import pytest
import torch

from repro_torch.kernels import match, queues, ref
from repro_torch.kernels import tasks as task_axis
from repro_torch.serve.engine import MeghaServeEngine, Request
from repro_torch.simx import (
    COMPONENTS,
    decompose_delays,
    FaultPlan,
    SimxConfig,
    TelemetryConfig,
    WorkerFailure,
    convert,
    runtime,
    simulate_workload,
    sweep,
)
from repro_torch.workload import traces
from repro_torch.workload.synth import synthetic_trace

WIDTHS = [1, 100, 128, 1024, 8192, 50_000]
#: the batched kernel's widths add narrow rows that share a thread's 8
#: lanes (7) or straddle threads (33, 100), the narrow design's edge (256,
#: 257) and the wide tile's edges (tile - 1, tile, tile + 1, 2 tile + 1)
_TILE = match.WIDE_TILE_LANES
BATCHED_WIDTHS = sorted(set(WIDTHS) | {7, 33, 64, 256, 257, _TILE - 1, _TILE, _TILE + 1,
                                       2 * _TILE + 1})
DTYPES = [torch.int8, torch.int32, torch.bool]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batched_matches_plain(avail: torch.Tensor, n: list[int]) -> None:
    nt = torch.tensor(n, dtype=torch.int32, device="cuda")
    before = match.match_ranks_batched.launches
    got = match.match_ranks_batched(avail, nt)
    torch.cuda.synchronize()
    assert match.match_ranks_batched.launches == before + 1
    assert torch.equal(got, ref.match_ranks_batched_ref(avail, nt))


@pytest.mark.gpu
@pytest.mark.parametrize("w", BATCHED_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_kernel_matches_plain_version(w, dtype):
    """Both designs of the batched kernel (narrow up to 256 lanes, wide
    above) over n in {0, 1, w/2, w, w+7} and random n, one row each."""
    _need_card()
    gen = torch.Generator().manual_seed(w)
    avail = (torch.rand((5, w), generator=gen) < 0.4).to(dtype).cuda()
    _batched_matches_plain(avail, [0, 1, w // 2, w, w + 7])
    _batched_matches_plain(avail, torch.randint(0, w + 1, (5,), generator=gen).tolist())
    _batched_matches_plain(avail[2:3].contiguous(), [w // 2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_kernel_narrow_pick_shape(dtype):
    """The sparrow/eagle head-of-queue pick at the paper's scale: 50,000
    rows of 64 queue slots, n = 1 and random n."""
    _need_card()
    gen = torch.Generator().manual_seed(64)
    avail = (torch.rand((50_000, 64), generator=gen) < 0.3).to(dtype).cuda()
    _batched_matches_plain(avail, [1] * 50_000)
    _batched_matches_plain(avail, torch.randint(0, 72, (50_000,), generator=gen).tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,lanes", [(300_000, 40), (50_000, 40), (13_000, 64)])
def test_cuda_kernel_queue_pick_at_path_shapes(rows, lanes):
    """The sparrow/eagle head-of-queue pick as the paths call it, n = 1 per
    row: the Fig. 2 grid at B = 6 and B = 1 (R = 40 at 50,000 workers)
    and eagle on the google-like trace (R = 64 at 13,000); each row's
    active lanes as a compacted queue leaves them (live entries first)."""
    _need_card()
    gen = torch.Generator().manual_seed(rows + lanes)
    active = torch.rand((rows, lanes), generator=gen) < 0.2
    fill = torch.randint(0, lanes + 1, (rows, 1), generator=gen)
    active &= torch.arange(lanes)[None, :] < fill
    active = active.cuda()
    assert match._batched_plan(lanes)[0] == "narrow"
    n = torch.ones((rows,), dtype=torch.int32, device="cuda")
    before = match.match_ranks_batched.launches
    got = match.match_ranks_batched(active, n)
    torch.cuda.synchronize()
    assert match.match_ranks_batched.launches == before + 1
    assert torch.equal(got, ref.match_ranks_batched_ref(active, n))
    assert int((got == 0).sum()) == int(active.any(1).sum())


def _mixed_trace():
    """Short and long jobs (every fourth 11-13 s, estimate above eagle's
    10 s threshold), so eagle's SSS and central match run."""
    rng = random.Random(5)
    jobs, t = [], 0.0
    for i in range(24):
        n = rng.randint(4, 24)
        lo, hi = (11.0, 13.0) if i % 4 == 1 else (0.2, 1.5)
        jobs.append(traces.Job(job_id=i, submit_time=t,
                               durations=[rng.uniform(lo, hi) for _ in range(n)]))
        t += rng.expovariate(4.0)
    return traces.Workload(name="mixed", jobs=jobs)


@pytest.mark.gpu
@pytest.mark.parametrize("name,trace", [("sparrow", "synth"), ("eagle", "synth"),
                                        ("eagle", "mixed"), ("sparrow", "small_cap")])
def test_queue_rule_card_run_is_bitwise_plain_and_cpu(name, trace):
    """Sparrow and eagle on the card with the kernel, without it, and on
    the CPU, final states bitwise equal; one pick a round, and eagle's
    central match beside it where long jobs run, and each queue kernel
    once a round; with one queue slot a worker, probes overflow and orphan
    rescue serves their jobs."""
    _need_card()
    if trace == "mixed":
        wl, W, kw = _mixed_trace(), 100, dict(dt=0.05)
    elif trace == "small_cap":
        wl = synthetic_trace(num_jobs=40, tasks_per_job=4, load=0.9, num_workers=32, seed=7)
        W, kw = 32, dict(dt=0.02, reserve_cap=1)
    else:
        wl = synthetic_trace(num_jobs=24, tasks_per_job=128, load=0.8, num_workers=1024,
                             seed=1)
        W, kw = 1024, dict(dt=0.02)
    before, q_before = match.match_ranks_batched.launches, _counts()
    t_before = task_axis.task_scan.launches
    card = simulate_workload(name, wl, W, device="cuda", **kw)
    launches = match.match_ranks_batched.launches - before
    # the queue passes: one launch of each kernel a round; the task-axis
    # pass once a round for sparrow, twice for eagle
    assert [a - b for a, b in zip(_counts(), q_before)] == [int(card.state.rnd)] * 3
    assert (task_axis.task_scan.launches - t_before
            == TASK_SCANS_PER_ROUND[name] * int(card.state.rnd))
    plain = simulate_workload(name, wl, W, device="cuda", use_kernel=False, **kw)
    assert match.match_ranks_batched.launches == before + launches
    cpu = simulate_workload(name, wl, W, device="cpu", **kw)
    per_round = 2 if trace == "mixed" else 1
    assert launches == per_round * int(card.state.rnd)
    want = convert.state_to_numpy(cpu.state)
    for other in (card, plain):
        got = convert.state_to_numpy(other.state)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert card.tasks_completed == wl.num_tasks
    if trace == "small_cap":
        assert int(card.state.res_overflow) > 0
    if trace == "mixed":
        assert int(card.state.probes) > int(card.state.probe_head) and int(card.state.long_head) > 0


# ---------------------------------------------------------------------------
# the reservation-queue kernels (``kernels.queues``, ``csrc/queues.cu``)
# ---------------------------------------------------------------------------

#: (points, workers, slots, jobs): the Sparrow cell's [16, 50000, 40] and
#: the stream's [1, 50000, 16] at their job counts, the widest row (256),
#: one unbatched queue, rows of 1, 7 and 33 slots (every lane-group width
#: and ragged slots), no job at all, and a job table too large for shared
#: memory (the kernels' device-memory variant)
QUEUE_SHAPES = [((16,), 50_000, 40, 480), ((1,), 50_000, 16, 193), ((2,), 3000, 256, 480),
                ((), 1000, 40, 480), ((3,), 777, 1, 5), ((2,), 500, 7, 60),
                ((4,), 1000, 33, 0), ((2,), 2000, 40, 20_000)]


def _queue_case(lead, w, r, j, gen):
    """Queues with live entries first (ascending job ids, some repeated),
    holes of J among them and J after them; a job table with zeros; idle
    and dead rows; all on the card."""
    shape = tuple(lead) + (w, r)
    jobs = torch.sort(torch.randint(0, max(j, 1), shape, generator=gen, dtype=torch.int32),
                      dim=-1).values
    fill = torch.randint(0, r + 1, shape[:-1] + (1,), generator=gen)
    live = (torch.arange(r) < fill) & (torch.rand(shape, generator=gen) < 0.9)
    resq = torch.where(live, jobs, j).to(torch.int32)
    table = torch.randint(0, 3, tuple(lead) + (j + 1,), generator=gen, dtype=torch.int32)
    table[..., -1] = 0
    idle = torch.rand(shape[:-1], generator=gen) < 0.6
    dead = torch.rand(shape[:-1], generator=gen) < 0.2
    return resq.cuda(), table.cuda(), idle.cuda(), dead.cuda()


#: the three wrappers, kept here so their counters stay readable while a
#: test replaces them in the module
_QUEUE_FNS = (queues.queue_compact, queues.queue_scan, queues.queue_head)


def _counts():
    return tuple(fn.launches for fn in _QUEUE_FNS)


@pytest.mark.gpu
@pytest.mark.parametrize("lead,w,r,j", QUEUE_SHAPES)
def test_queue_kernels_are_bitwise_their_plain_versions(lead, w, r, j):
    """Each of the three kernels against its plain version in ``ref.py``
    on the same card tensors: compaction (and its buffer's pad slot), the
    scan with and without the row mask and the dead rows, and the head
    after the n = 1 pick and after ranks with several zeros a row."""
    _need_card()
    gen = torch.Generator().manual_seed(w * 7 + r * 3 + j)
    resq, table, idle, dead = _queue_case(lead, w, r, j, gen)
    before = _counts()
    buf, fill = queues.queue_compact(resq, table)
    want, want_fill = ref.queue_compact_ref(resq, table)
    torch.cuda.synchronize()
    assert buf.shape == (resq.numel() + 1,) and int(buf[-1]) == j
    assert torch.equal(buf[:-1].view(resq.shape), want) and torch.equal(fill, want_fill)
    out = buf[:-1].view(resq.shape)
    for row_mask, dead_w in ((None, None), (idle, None), (None, dead), (idle, dead)):
        active, has_res = queues.queue_scan(out, table, row_mask, dead_w)
        want_a, want_h = ref.queue_scan_ref(out, table, row_mask, dead_w)
        torch.cuda.synchronize()
        assert torch.equal(active, want_a) and torch.equal(has_res, want_h)
    rows = active.reshape(-1, r)
    ranks = match.match_ranks_batched(rows, torch.ones(rows.shape[0], dtype=torch.int32,
                                                       device="cuda"))
    many = torch.randint(-1, 2, resq.shape, generator=gen, dtype=torch.int32).cuda()
    for rk in (ranks, many):
        head = queues.queue_head(out, rk, j)
        torch.cuda.synchronize()
        assert torch.equal(head, ref.queue_head_ref(out, rk, j))
    assert _counts() == (before[0] + 1, before[1] + 4, before[2] + 2)
    if j > 0:
        assert bool(active.any()) and bool(has_res.any()) and bool((head < j).any())


@pytest.mark.gpu
def test_queue_kernels_refuse_rows_past_256_slots():
    _need_card()
    resq = torch.zeros((2, 10, queues.MAX_LANES + 1), dtype=torch.int32, device="cuda")
    table = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    before = _counts()
    with pytest.raises(ValueError, match="at most 256"):
        queues.queue_compact(resq, table)
    with pytest.raises(ValueError, match="at most 256"):
        queues.queue_scan(resq, table)
    with pytest.raises(ValueError, match="at most 256"):
        queues.queue_head(resq, torch.zeros_like(resq), 1)
    assert _counts() == before


# ---------------------------------------------------------------------------
# the task-axis pass (``kernels.tasks``, ``csrc/tasks.cu``)
# ---------------------------------------------------------------------------

#: task_scan launches a round: sparrow's one pass, eagle's two (before and
#: after its sticky launches)
TASK_SCANS_PER_ROUND = {"sparrow": 1, "eagle": 2}

_TASK_TILE = task_axis.TILE_TASKS
#: the wrapper, kept here so its counter stays readable while a test
#: replaces it in the module
_TASK_SCAN = task_axis.task_scan
#: (points, tasks, jobs, job layout): the Sparrow cell's [48, 480000] of 480
#: jobs of 1,000 and its 16-point [16, 480000]; the 4-lane stream curve's
#: [4, 196608] lane-stacked windows; one unbatched row; rows at a tile's
#: edges and ragged rows (scalar loads where a row is not 16-byte aligned);
#: many small jobs (some empty); jobs in no order
TASK_SHAPES = [((48,), 480_000, 480, "even"), ((16,), 480_000, 480, "even"),
               ((4,), 196_608, 192, "lanes"), ((), 10_000, 10, "even"),
               ((3,), _TASK_TILE - 1, 3, "even"), ((3,), _TASK_TILE, 5, "even"),
               ((3,), _TASK_TILE + 1, 4, "small"), ((2,), 8194, 4, "even"),
               ((2,), 30_000, 7_000, "small"), ((2,), 50_000, 300, "unsorted")]
TASK_MODES = ["mixed", "all_pending", "none_pending", "unfinished_only"]


def _task_job_rows(lead, T, J, layout, gen):
    """int32 job ids: ``even`` T // J tasks a job in job order, the rest the
    pad job J; ``small`` sorted random ids (jobs of any size, some empty);
    ``unsorted`` random ids; ``lanes`` one sorted row per point, its last
    tenth the pad job."""
    if layout == "even":
        k = T // J
        return torch.cat([torch.arange(J).repeat_interleave(k),
                          torch.full((T - J * k,), J)]).to(torch.int32)
    if layout == "lanes":
        rows = torch.sort(torch.randint(0, J, tuple(lead) + (T,), generator=gen), -1).values
        rows[..., T - T // 10:] = J
        return rows.to(torch.int32)
    ids = torch.randint(0, J, (T,), generator=gen, dtype=torch.int32)
    return torch.sort(ids).values if layout == "small" else ids


def _task_case(lead, T, J, layout, mode, gen):
    """A round's task axis on the card: finish times finished, running or
    unlaunched (inf), submits per point (a tenth equal to t), t per point."""
    shape = tuple(lead) + (T,)
    t = (1.0 + 3.0 * torch.rand(tuple(lead), generator=gen)).float()
    fin = 5.0 * torch.rand(shape, generator=gen)
    fin = torch.where(torch.rand(shape, generator=gen) < 0.1, t[..., None], fin)
    sub = 5.0 * torch.rand(shape, generator=gen)
    sub = torch.where(torch.rand(shape, generator=gen) < 0.1, t[..., None], sub)
    unlaunched = torch.rand(shape, generator=gen) < 0.45
    if mode == "all_pending":
        unlaunched, sub = torch.ones_like(unlaunched), torch.zeros_like(sub)
    elif mode == "none_pending":
        unlaunched = torch.zeros_like(unlaunched)
    fin = torch.where(unlaunched, float("inf"), fin).float()
    job = _task_job_rows(lead, T, J, layout, gen)
    return fin.cuda(), sub.float().cuda(), job.cuda(), t.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", TASK_MODES)
@pytest.mark.parametrize("lead,T,J,layout", TASK_SHAPES)
def test_task_scan_is_bitwise_its_plain_version(lead, T, J, layout, mode):
    """The kernel against its plain version on the same card tensors: both
    counts, and each row's pending list up to the row's pending total (the
    kernel leaves the rest unwritten); one launch a call."""
    _need_card()
    gen = torch.Generator().manual_seed(T * 3 + J + TASK_MODES.index(mode))
    fin, sub, job, t = _task_case(lead, T, J, layout, mode, gen)
    sub = None if mode == "unfinished_only" else sub
    before = task_axis.task_scan.launches
    got = task_axis.task_scan(fin, sub, job, t, J)
    want = ref.task_scan_ref(fin, sub, job, t, J)
    torch.cuda.synchronize()
    assert task_axis.task_scan.launches == before + 1
    assert torch.equal(got[0], want[0])
    if sub is None:
        assert got[1:] == (None, None)
        return
    assert torch.equal(got[1], want[1])
    total = want[1].sum(-1, dtype=torch.int32)
    listed = torch.arange(T, device="cuda") < total[..., None]
    assert torch.equal(torch.where(listed, got[2], T), want[2])
    if mode == "all_pending":
        assert bool((total == T).all())
    if mode == "mixed":
        assert bool((total > 0).all()) and bool((total < T).all())


@pytest.mark.gpu
def test_task_scan_shares_the_look_back_scratch_with_the_match():
    """The list's look-back words are the match kernels' scratch on the
    stream (epoch-tagged): launches of both in turn stay bitwise."""
    _need_card()
    gen = torch.Generator().manual_seed(5)
    fin, sub, job, t = _task_case((8,), 50_000, 50, "even", "mixed", gen)
    avail = (torch.rand((8, 49_984), generator=gen) < 0.4).cuda()
    n = torch.full((8,), 10_000, dtype=torch.int32, device="cuda")
    for _ in range(3):
        got = task_axis.task_scan(fin, sub, job, t, 50)
        ranks = match.match_ranks_batched(avail, n)
        want = ref.task_scan_ref(fin, sub, job, t, 50)
        total = want[1].sum(-1, dtype=torch.int32)
        listed = torch.arange(50_000, device="cuda") < total[..., None]
        assert torch.equal(torch.where(listed, got[2], 50_000), want[2])
        assert torch.equal(ranks, ref.match_ranks_batched_ref(avail, n))


def _plain_queue_passes(monkeypatch):
    """The three queue wrappers and the task-axis pass replaced by their
    plain versions, on any device."""
    def compact(resq, unfinished):
        out, fill = ref.queue_compact_ref(resq, unfinished)
        buf = torch.empty(resq.numel() + 1, dtype=torch.int32, device=resq.device)
        buf[:-1].view(resq.shape).copy_(out)
        buf[-1] = unfinished.shape[-1] - 1
        return buf, fill

    monkeypatch.setattr(queues, "queue_compact", compact)
    monkeypatch.setattr(queues, "queue_scan", ref.queue_scan_ref)
    monkeypatch.setattr(queues, "queue_head", ref.queue_head_ref)
    monkeypatch.setattr(task_axis, "task_scan", ref.task_scan_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sparrow", "eagle"])
def test_queue_grid_on_the_card_is_bitwise_the_plain_queue_passes(name, monkeypatch):
    """A whole grid of B = 2 points through the queue kernels and the
    task-axis pass equals the same grid with their plain versions on the
    card, final states bitwise; each queue kernel launches once a round,
    the task-axis pass once (sparrow) or twice (eagle)."""
    _need_card()
    kw = {k: v for k, v in SMALL_GRID.items() if k != "loads"}
    tasks, sub, jsub = sweep.make_load_grid((0.8,), device="cuda", **kw)

    def grid():
        state, _, _ = sweep.grid_state(
            name, SimxConfig(**SMALL_CFG), tasks, sub, jsub, (0, 1), GRID_ROUNDS,
            match_fn=runtime.default_match_fn(True))
        torch.cuda.synchronize()
        return state

    before, t_before = _counts(), _TASK_SCAN.launches
    card = grid()
    launched = [a - b for a, b in zip(_counts(), before)]
    scans = _TASK_SCAN.launches - t_before
    assert card.t.shape == (2,)
    assert launched == [GRID_ROUNDS] * 3
    assert scans == TASK_SCANS_PER_ROUND[name] * GRID_ROUNDS
    _plain_queue_passes(monkeypatch)
    plain = grid()
    assert [a - b for a, b in zip(_counts(), before)] == launched
    assert _TASK_SCAN.launches - t_before == scans
    want = convert.state_to_numpy(plain)
    got = convert.state_to_numpy(card)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (card.task_finish <= card.t[:, None]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "oracle"])
def test_card_run_is_bitwise_the_cpu_run(name):
    _need_card()
    wl = synthetic_trace(num_jobs=24, tasks_per_job=128, load=0.8, num_workers=1024, seed=1)
    before = match.match_ranks_batched.launches
    card = simulate_workload(name, wl, 1024, dt=0.02, device="cuda")
    launches = match.match_ranks_batched.launches - before
    cpu = simulate_workload(name, wl, 1024, dt=0.02, device="cpu")
    assert launches == int(card.state.rnd) + card.borrow_rounds
    a, b = convert.state_to_numpy(card.state), convert.state_to_numpy(cpu.state)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert card.tasks_completed == wl.num_tasks


@pytest.mark.gpu
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_single_row_kernel_matches_plain_version(w, dtype):
    """Both entry points of the single-row kernel over n in {0, 1, w/2, w,
    w+7} (by value and from the device) and max_tasks in {512, w}."""
    _need_card()
    gen = torch.Generator().manual_seed(w + 1)
    avail = (torch.rand((w,), generator=gen) < 0.4).to(dtype).cuda()
    for n in (0, 1, w // 2, w, w + 7):
        for count in (n, torch.tensor(n, dtype=torch.int32, device="cuda")):
            before = match.match_ranks.launches
            got = match.match_ranks(avail, count)
            assert match.match_ranks.launches == before + 1
            assert torch.equal(got, ref.match_ranks_ref(avail, n))
            for max_tasks in (512, w):
                before = match.match_tasks.launches
                a, p = match.match_tasks(avail, count, max_tasks)
                torch.cuda.synchronize()
                assert match.match_tasks.launches == before + 1
                wa, wp = ref.match_tasks_ref(avail, min(n, max_tasks), max_tasks)
                assert torch.equal(a, wa) and torch.equal(p, wp)


@pytest.mark.gpu
def test_single_row_kernel_survives_epoch_wrap():
    """The look-back scratch is zeroed when its epoch wraps; results stay
    right across the wrap."""
    _need_card()
    avail = (torch.rand((50_000,), generator=torch.Generator().manual_seed(3)) < 0.5).cuda()
    want = ref.match_tasks_ref(avail, 512, 512)
    match.match_tasks(avail, 512, 512)
    key = (avail.device.index, torch.cuda.current_stream().cuda_stream)
    match._SCRATCH[key].epoch = match._MAX_EPOCH - 1
    for _ in range(4):
        a, p = match.match_tasks(avail, 512, 512)
        assert torch.equal(a, want[0]) and torch.equal(p, want[1])
    assert match._SCRATCH[key].epoch == 3


@pytest.mark.gpu
def test_cuda_kernel_wide_rows_past_one_grid():
    """More wide rows than one launch's grid holds (65,535): the launch is
    split into chunks of rows, each with its own status words."""
    _need_card()
    gen = torch.Generator().manual_seed(6)
    avail = (torch.rand((65_538, 300), generator=gen) < 0.5).cuda()
    _batched_matches_plain(avail, torch.randint(0, 301, (65_538,), generator=gen).tolist())


@pytest.mark.gpu
def test_batched_kernel_survives_epoch_wrap():
    """The wide design shares the look-back scratch and its epochs; results
    stay right across the wrap."""
    _need_card()
    avail = (torch.rand((8, 49_984), generator=torch.Generator().manual_seed(4)) < 0.5).cuda()
    n = torch.tensor([0, 1, 100, 3000, 24_000, 25_000, 49_984, 60_000],
                     dtype=torch.int32, device="cuda")
    want = ref.match_ranks_batched_ref(avail, n)
    match.match_ranks_batched(avail, n)
    key = (avail.device.index, torch.cuda.current_stream().cuda_stream)
    match._SCRATCH[key].epoch = match._MAX_EPOCH - 1
    for _ in range(4):
        assert torch.equal(match.match_ranks_batched(avail, n), want)
    assert match._SCRATCH[key].epoch == 3


@pytest.mark.gpu
def test_batched_and_single_row_launches_share_one_scratch():
    """Batched and single-row launches in turns on one stream, each taking
    the next epoch of the same status words, with no synchronize between
    them; every result equals its plain version."""
    _need_card()
    gen = torch.Generator().manual_seed(5)
    wide = (torch.rand((8, 49_984), generator=gen) < 0.5).cuda()
    narrow = (torch.rand((4096, 64), generator=gen) < 0.3).cuda()
    row = (torch.rand((49_984,), generator=gen) < 0.5).cuda()
    n_wide = torch.randint(0, 49_985, (8,), generator=gen, dtype=torch.int32).cuda()
    n_narrow = torch.ones((4096,), dtype=torch.int32, device="cuda")
    outs = []
    for i in range(6):
        outs.append(("batched", match.match_ranks_batched(wide, n_wide)))
        outs.append(("tasks", match.match_tasks(row, 512 + i, 512)))
        outs.append(("narrow", match.match_ranks_batched(narrow, n_narrow)))
        outs.append(("ranks", match.match_ranks(row, 1000 * i)))
    torch.cuda.synchronize()
    for i, (kind, got) in enumerate(outs):
        if kind == "batched":
            assert torch.equal(got, ref.match_ranks_batched_ref(wide, n_wide))
        elif kind == "narrow":
            assert torch.equal(got, ref.match_ranks_batched_ref(narrow, n_narrow))
        elif kind == "tasks":
            want = ref.match_tasks_ref(row, 512, 512)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        else:
            assert torch.equal(got, ref.match_ranks_ref(row, 1000 * (i // 4)))


@pytest.mark.gpu
def test_card_engine_is_bitwise_the_cpu_engine():
    _need_card()
    engines = {}
    for dev in ("cpu", "cuda"):
        eng = MeghaServeEngine(num_frontends=4, num_pods=4, slots_per_pod=64, device=dev)
        rng = np.random.default_rng(0)
        before = match.match_tasks.launches
        eng.submit([Request(i, gen_len=int(rng.integers(1, 20))) for i in range(1500)])
        eng.run_until_drained()
        engines[dev] = (eng, match.match_tasks.launches - before)
    (cpu, _), (card, launches) = engines["cpu"], engines["cuda"]
    assert launches == card.gm_rounds > 0
    assert cpu.stats == card.stats
    assert torch.equal(cpu.truth, card.truth.cpu())
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu.views, card.views))


#: the sweep tests' small grid: 2 loads x 2 seeds on 64 workers
SMALL_GRID = dict(loads=(0.5, 0.8), num_jobs=8, tasks_per_job=16, num_workers=64, seed=11)
SMALL_CFG = dict(num_workers=64, num_gms=4, num_lms=4, dt=0.02, heartbeat_interval=1.0)


#: the small grid's round budget (``estimate_rounds`` at load 0.5)
GRID_ROUNDS = 711


def _grid(name: str, device: str, use_kernel: bool = True):
    """The small grid on ``device``; returns (state, step, launches)."""
    loads = SMALL_GRID["loads"]
    kw = {k: v for k, v in SMALL_GRID.items() if k != "loads"}
    tasks, sub, jsub = sweep.make_load_grid(loads, device=device, **kw)
    before = match.match_ranks_batched.launches
    state, _, step = sweep.grid_state(
        name, SimxConfig(**SMALL_CFG), tasks, sub, jsub, (0, 1), GRID_ROUNDS,
        match_fn=runtime.default_match_fn(use_kernel))
    return state, step, match.match_ranks_batched.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_grid_on_the_card_is_bitwise_plain_and_cpu(name):
    """The batched grid: kernel path, plain path on the card and the CPU
    run, final states bitwise equal; one launch per match (megha's borrow
    pass once for the whole batch, pigeon's two matches a round)."""
    _need_card()
    card, step, launches = _grid(name, "cuda")
    plain, _, plain_launches = _grid(name, "cuda", use_kernel=False)
    cpu, _, _ = _grid(name, "cpu")
    # sparrow's and eagle's one match is the pick (no long job here)
    per_round = {"megha": 1, "sparrow": 1, "eagle": 1, "pigeon": 2, "oracle": 1}[name]
    assert launches == per_round * GRID_ROUNDS + getattr(step, "borrow_rounds", 0)
    assert plain_launches == 0
    want = convert.state_to_numpy(cpu)
    for other in (card, plain):
        got = convert.state_to_numpy(other)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (card.task_finish <= card.t[:, None]).all()


@pytest.mark.gpu
def test_pigeon_card_run_is_bitwise_the_cpu_run():
    """Pigeon alone, with a ragged last group (100 workers in groups of
    40: the narrow design on rows of 60 lanes, the first row padded)."""
    _need_card()
    wl = synthetic_trace(num_jobs=12, tasks_per_job=32, load=0.9, num_workers=100, seed=4)
    before = match.match_ranks_batched.launches
    card = simulate_workload("pigeon", wl, 100, dt=0.02, device="cuda")
    launches = match.match_ranks_batched.launches - before
    cpu = simulate_workload("pigeon", wl, 100, dt=0.02, device="cpu")
    assert launches == 2 * int(card.state.rnd)
    a, b = convert.state_to_numpy(card.state), convert.state_to_numpy(cpu.state)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert card.tasks_completed == wl.num_tasks


@pytest.mark.gpu
@pytest.mark.parametrize("rows,lanes,real", [(7500, 40, 40), (2500, 60, 40), (6, 60, 60)])
def test_narrow_design_at_pigeon_shapes(rows, lanes, real):
    """Pigeon's batched match at the paper's grid ([6 x 1250, 40]) and
    rows of a ragged last group: groups of 40 padded to 60 lanes that read
    busy, and full 60-lane rows; n up to the row width and beyond."""
    _need_card()
    gen = torch.Generator().manual_seed(rows + lanes)
    avail = torch.rand((rows, lanes), generator=gen) < 0.5
    avail[:, real:] = False
    avail = avail.cuda()
    assert match._batched_plan(lanes)[0] == "narrow"
    _batched_matches_plain(avail, torch.randint(0, lanes + 3, (rows,), generator=gen).tolist())
    _batched_matches_plain(avail, [lanes] * rows)


#: a small Fig. 4 grid: 2 crash fractions x 2 seeds at 256 workers, megha
#: also losing one of its 4 GMs
FIG4_GRID = dict(fractions=(0.0, 0.25), num_seeds=2, num_workers=256, num_jobs=12,
                 tasks_per_job=64, outage=2.0, gm_outages=1, dt=0.05, num_gms=4, num_lms=4,
                 heartbeat_interval=1.0)


def _fig4_grid(name: str, device: str, use_kernel: bool = True):
    """The small Fig. 4 grid on ``device``; returns (state, step, launches,
    rounds)."""
    plan = sweep.fig4_plan(name, use_kernel=use_kernel, device=device, **FIG4_GRID)
    before = match.match_ranks_batched.launches
    state, step = sweep.fault_grid_state(plan.name, plan.cfg, plan.tasks, plan.schedules,
                                         plan.seeds, plan.num_rounds, match_fn=plan.match_fn)
    return state, step, match.match_ranks_batched.launches - before, plan.num_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_fig4_grid_on_the_card_is_bitwise_plain_and_cpu(name):
    """The Fig. 4 grid: kernel path, plain path on the card and the CPU
    run, final states bitwise equal; one launch per match a round (megha
    adds its borrow rounds; eagle's SSS is on, its one match the pick);
    nothing lost at fraction 0, something at 0.25, every task done."""
    _need_card()
    card, step, launches, rounds = _fig4_grid(name, "cuda")
    plain, _, plain_launches, _ = _fig4_grid(name, "cuda", use_kernel=False)
    cpu, _, _, _ = _fig4_grid(name, "cpu")
    per_round = {"megha": 1, "sparrow": 1, "eagle": 1, "pigeon": 2, "oracle": 1}[name]
    assert launches == per_round * rounds + getattr(step, "borrow_rounds", 0)
    assert plain_launches == 0
    want = convert.state_to_numpy(cpu)
    for other in (card, plain):
        got = convert.state_to_numpy(other)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (card.task_finish <= card.t[:, None]).all()
    assert card.lost[:2].tolist() == [0, 0] and min(card.lost[2:].tolist()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("rows,lanes,n", [(64, 49_984, None), (64, 6248, None),
                                          (8, 50_000, None), (10_000, 40, None),
                                          (400_000, 40, 1)])
def test_cuda_kernel_at_fig4_shapes(rows, lanes, n):
    """The kernel at the Fig. 4 grid's shapes (B = 8): megha's borrow and
    internal matches, the oracle's, pigeon's groups and the sparrow/eagle
    pick; n = W (every row scanned to its end), random n, and the pick's
    n = 1."""
    _need_card()
    gen = torch.Generator().manual_seed(rows + lanes)
    avail = (torch.rand((rows, lanes), generator=gen) < 0.5).cuda()
    if n is None:
        _batched_matches_plain(avail, [lanes] * rows)
        _batched_matches_plain(avail, torch.randint(0, lanes + 1, (rows,),
                                                    generator=gen).tolist())
    else:
        _batched_matches_plain(avail, [n] * rows)


def _tel_run(name: str, device: str, use_kernel: bool = True, flags: bool = True):
    """A small run under a crash wave with telemetry and provenance on (or
    both off), in chunks of whole telemetry windows, so that both read the
    done probe after the same rounds; returns (run, launches)."""
    wl = synthetic_trace(num_jobs=12, tasks_per_job=32, load=0.9, num_workers=128, seed=4)
    plan = FaultPlan(worker_failures=tuple(WorkerFailure(w, 1.0 + 0.01 * w, 3.0)
                                           for w in range(0, 128, 5)))
    before = match.match_ranks_batched.launches
    run = simulate_workload(name, wl, 128, num_gms=4, num_lms=4, heartbeat_interval=1.0,
                            dt=0.05, faults=plan, use_kernel=use_kernel, device=device,
                            chunk=250,
                            telemetry=TelemetryConfig(stride=5) if flags else None,
                            provenance=flags)
    return run, match.match_ranks_batched.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_telemetry_and_provenance_on_the_card_are_bitwise_plain_and_cpu(name):
    """A run with both stages on, under crashes: the kernel path, the plain
    path on the card and the CPU run agree bitwise in state, Timeline and
    Provenance; the stages add no kernel launch and change no state."""
    _need_card()
    card, launches = _tel_run(name, "cuda")
    plain, plain_launches = _tel_run(name, "cuda", use_kernel=False)
    cpu, _ = _tel_run(name, "cpu")
    off, off_launches = _tel_run(name, "cuda", flags=False)
    assert launches == off_launches > 0 and plain_launches == 0
    want = [convert.state_to_numpy(cpu.state), convert.state_to_numpy(cpu.provenance),
            {k: v.numpy() for k, v in cpu.timeline.series.items()}
            | {"t": cpu.timeline.t.numpy(), "delay_hist": cpu.timeline.delay_hist.numpy()}]
    for run in (card, plain):
        got = [convert.state_to_numpy(run.state), convert.state_to_numpy(run.provenance),
               {k: v.cpu().numpy() for k, v in run.timeline.series.items()}
               | {"t": run.timeline.t.cpu().numpy(),
                  "delay_hist": run.timeline.delay_hist.cpu().numpy()}]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    a, b = convert.state_to_numpy(off.state), want[0]
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    assert int(card.provenance.requeue_count.sum()) == card.lost_tasks > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_breakdown_grid_on_the_card_is_bitwise_plain_and_cpu(name):
    """The small grid with provenance: kernel path, plain path and CPU
    bitwise in state, Provenance and every job's delay components; the
    breakdown columns bitwise kernel = plain, and card = CPU within the
    sweep tolerance (rtol 1e-5: ``nanmean`` sums in another order on the
    card); the launches those of the grid without provenance."""
    _need_card()
    loads = SMALL_GRID["loads"]
    kw = {k: v for k, v in SMALL_GRID.items() if k != "loads"}
    cfg = SimxConfig(**SMALL_CFG)
    out = {}
    for dev, use_kernel in (("cuda", True), ("cuda", False), ("cpu", True)):
        tasks, sub, jsub = sweep.make_load_grid(loads, device=dev, **kw)
        before = match.match_ranks_batched.launches
        (state, prov), ptasks, _ = sweep.grid_state(
            name, cfg, tasks, sub, jsub, (0, 1), GRID_ROUNDS,
            match_fn=runtime.default_match_fn(use_kernel), provenance=True)
        launches = match.match_ranks_batched.launches - before
        dec = decompose_delays(prov, state.task_finish, state.t, ptasks, cfg.dt)
        arrays = (convert.state_to_numpy(state) | {f"prov.{k}": v for k, v in
                                                   convert.state_to_numpy(prov).items()}
                  | {f"dec.{k}": v.cpu().numpy() for k, v in dec.items()})
        summary = {k: v.cpu().numpy() for k, v in
                   sweep.point_summary(state, ptasks, provenance=prov, dt=cfg.dt).items()}
        out[dev, use_kernel] = arrays, summary, launches
    _, _, off_launches = _grid(name, "cuda")
    assert out["cuda", True][2] == off_launches > 0 and out["cuda", False][2] == 0
    want, want_summary, _ = out["cpu", True]
    assert {f"mean_{c}" for c in COMPONENTS} <= set(want_summary)
    for key in (("cuda", True), ("cuda", False)):
        got = out[key][0]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k], want[k], equal_nan=True), k
    card, plain = out["cuda", True][1], out["cuda", False][1]
    for k, v in want_summary.items():
        assert np.array_equal(card[k], plain[k], equal_nan=True), k
        np.testing.assert_allclose(card[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the streaming engine and the P² sketch kernel
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 3, 5, 6, 1000, 5000])
@pytest.mark.parametrize("split", [1, 3])
def test_p2_kernel_is_bitwise_its_plain_version(n, split):
    """The P² absorb kernel against the plain recursion on the card, on a
    seeded bimodal stream with a random mask, absorbed in ``split`` calls:
    every marker, position, buffer entry and the count bitwise after each,
    one launch per call."""
    _need_card()
    from repro_torch.kernels import p2
    from repro_torch.simx import telemetry as tlm

    rng = np.random.default_rng(n + 7 * split)
    vals = np.concatenate([rng.lognormal(0.0, 0.6, n - n // 3), 4.0 + rng.lognormal(0.0, 0.4, n // 3)])
    rng.shuffle(vals)
    vals = torch.from_numpy(vals.astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.random(n) < 0.8).cuda()
    kern = plain = tlm.sketch_init(device="cuda")
    for part in np.array_split(np.arange(n), split):
        idx = torch.from_numpy(part).cuda()
        before = p2.p2_absorb.launches
        kern = p2.p2_absorb(kern, vals[idx], mask[idx])
        assert p2.p2_absorb.launches == before + 1
        plain = tlm.sketch_absorb(plain, vals[idx], mask[idx])
        torch.cuda.synchronize()
        for f in ("q", "n", "npd", "buf", "count"):
            assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert int(kern.count) == int(mask.sum())
    assert torch.equal(tlm.sketch_quantiles(kern), tlm.sketch_quantiles(plain)) or n == 0


@pytest.mark.gpu
def test_p2_kernel_many_quantiles_and_walk_cycles():
    """Forty target quantiles (two blocks of one warp) over 5,000 values in
    three tiles of staged values: bitwise the plain version; the kernel's
    walk reports its SM cycles, and the clock probe a plausible clock."""
    _need_card()
    from repro_torch.kernels import p2
    from repro_torch.simx import telemetry as tlm

    rng = np.random.default_rng(40)
    vals = torch.from_numpy(rng.lognormal(0.0, 0.8, 5000).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.random(5000) < 0.9).cuda()
    targets = tuple(float(q) for q in np.linspace(0.02, 0.98, 40))
    sk = tlm.sketch_init(targets, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    kern = p2.p2_absorb(sk, vals, mask, cycles=cycles)
    plain = tlm.sketch_absorb(sk, vals, mask)
    for f in ("q", "n", "npd", "buf", "count"):
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert int(cycles) > 0
    assert 5e8 < p2.clock_hz("cuda", spin=20_000_000) < 3e9


def _stream_run(name: str, device: str, use_kernel: bool = True):
    """A small stream (the CPU tests' configuration: 128 workers, the small
    window) of bimodal Poisson arrivals to a horizon, telemetry and
    provenance on; returns (run, match launches, P² launches)."""
    from repro_torch.kernels import p2
    from repro_torch.simx import stream
    from repro_torch.workload.synth import PoissonArrivals, bimodal_job_factory

    arr = PoissonArrivals(rate=3.0, job_factory=bimodal_job_factory(8), seed=5, num_jobs=24)
    m0, p0 = match.match_ranks_batched.launches, p2.p2_absorb.launches
    run = stream.run_steady_state(name, arr, 128, window_jobs=8, window_tasks=80,
                                  rounds_per_refill=16, horizon=12.0, num_gms=4, num_lms=4,
                                  telemetry=True, provenance=True, use_kernel=use_kernel,
                                  device=device)
    return run, match.match_ranks_batched.launches - m0, p2.p2_absorb.launches - p0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_stream_on_the_card_is_bitwise_plain_and_cpu(name):
    """The streamed run on the card with the kernels, with their plain
    versions, and on the CPU: delays, series, refills, sketch estimates,
    counters, Timeline and breakdown bitwise; one P² launch per refill."""
    _need_card()
    card, launches, p2_launches = _stream_run(name, "cuda")
    plain, plain_launches, plain_p2 = _stream_run(name, "cuda", use_kernel=False)
    cpu, _, _ = _stream_run(name, "cpu")
    assert launches > 0 and plain_launches == 0 and plain_p2 == 0
    assert p2_launches == len(card.refills)
    for run in (card, plain):
        assert np.array_equal(run.delays, cpu.delays)
        for k in cpu.series:
            assert np.array_equal(run.series[k], cpu.series[k], equal_nan=True), k
        assert run.refills == cpu.refills
        assert np.array_equal(run.quantile_estimates, cpu.quantile_estimates, equal_nan=True)
        for f in ("tasks_completed", "messages", "probes", "rounds", "end_time",
                  "state_bytes", "borrow_rounds"):
            assert getattr(run, f) == getattr(cpu, f), f
        for k, v in cpu.timeline.series.items():
            assert np.array_equal(run.timeline.series[k].cpu().numpy(), v.numpy()), k
        assert run.breakdown["sum"] == cpu.breakdown["sum"]


# ---------------------------------------------------------------------------
# the sharded steady state: the P² kernel's lane axis, a lane-batched curve
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,n", [(1, 300), (4, 193), (3, 50)])
def test_p2_kernel_lanes_are_bitwise_the_plain_version(lanes, n):
    """The kernel over ``[L, N]`` values (one launch a call, two calls):
    bitwise the plain lane-batched absorb and each lane's own 1-D kernel
    call; lane 1 (when there is one) has no valid value and stays fresh;
    a ``[1, N]`` call is bitwise the 1-D call."""
    _need_card()
    from repro_torch.kernels import p2
    from repro_torch.simx import telemetry as tlm

    rng = np.random.default_rng(lanes * 1000 + n)
    vals = torch.from_numpy(rng.lognormal(0.0, 0.7, (lanes, n)).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.random((lanes, n)) < 0.3).cuda()
    if lanes > 1:
        mask[1] = False
    kern = plain = tlm.sketch_init(device="cuda", lanes=lanes)
    alone = [tlm.sketch_init(device="cuda") for _ in range(lanes)]
    for part in (slice(0, n // 2), slice(n // 2, n)):
        v, m = vals[:, part].contiguous(), mask[:, part].contiguous()
        before = p2.p2_absorb.launches
        kern = p2.p2_absorb(kern, v, m)
        assert p2.p2_absorb.launches == before + 1
        plain = tlm.sketch_absorb(plain, v, m)
        alone = [p2.p2_absorb(a, v[i], m[i]) for i, a in enumerate(alone)]
        torch.cuda.synchronize()
        for f in ("q", "n", "npd", "buf", "count"):
            assert torch.equal(getattr(kern, f), getattr(plain, f)), f
            assert torch.equal(getattr(kern, f), torch.stack([getattr(a, f) for a in alone])), f
    assert kern.count.tolist() == mask.sum(dim=1).tolist()
    if lanes > 1:
        fresh = tlm.sketch_init(device="cuda")
        assert torch.equal(kern.q[1], fresh.q)
    if lanes == 1:
        one = p2.p2_absorb(tlm.sketch_init(device="cuda"), vals[0], mask[0])
        assert torch.equal(kern.q[0], one.q)


def _curve_run(name: str, device: str, use_kernel: bool = True):
    """A small 3-lane curve (128 workers, the small window, loads 0.5 /
    0.9 / 0.7 of different lengths) on a 2-entry mesh of ``device``;
    returns (runs, match launches, P² launches)."""
    from repro_torch.kernels import p2
    from repro_torch.simx import shard
    from repro_torch.workload.synth import PoissonArrivals, fixed_job_factory

    arr = [PoissonArrivals(rate=ld * 128 / 8.0, job_factory=fixed_job_factory(8, 1.0),
                           seed=7, num_jobs=n) for ld, n in ((0.5, 24), (0.9, 12), (0.7, 40))]
    m0, p0 = match.match_ranks_batched.launches, p2.p2_absorb.launches
    runs = shard.sharded_steady_state(
        name, arr, 128, mesh=shard.Mesh((device,) * 2), window_jobs=8, window_tasks=80,
        rounds_per_refill=16, num_gms=4, num_lms=4, use_kernel=use_kernel)
    return runs, match.match_ranks_batched.launches - m0, p2.p2_absorb.launches - p0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow"])
def test_lane_curve_on_the_card_is_bitwise_plain_and_cpu(name):
    """The lane-batched curve on the card with the kernels, with their
    plain versions, and on the CPU: every lane's delays, series, refills,
    sketch estimates and counters bitwise; one P² launch a segment and
    entry."""
    _need_card()
    card, launches, p2_launches = _curve_run(name, "cuda")
    plain, plain_launches, plain_p2 = _curve_run(name, "cuda", use_kernel=False)
    cpu, _, _ = _curve_run(name, "cpu")
    assert launches > 0 and plain_launches == 0 and plain_p2 == 0
    assert p2_launches == 2 * max(len(r.refills) for r in card)
    assert len({r.rounds for r in cpu}) == 3
    for runs in (card, plain):
        for run, want in zip(runs, cpu):
            assert np.array_equal(run.delays, want.delays)
            for k in want.series:
                assert np.array_equal(run.series[k], want.series[k], equal_nan=True), k
            assert run.refills == want.refills
            assert np.array_equal(run.quantile_estimates, want.quantile_estimates,
                                  equal_nan=True)
            for f in ("tasks_completed", "messages", "probes", "rounds", "end_time",
                      "state_bytes", "borrow_rounds"):
                assert getattr(run, f) == getattr(want, f), f


# ---------------------------------------------------------------------------
# host syncs per round, pinned (``repro_torch.analysis.sentinels``)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_host_syncs_per_round_are_pinned(name):
    """A short fixed-trace run on the card (the step built and one round
    run beforehand, so the kernels are built and loaded) makes exactly the
    pinned host syncs a round: any new host read in a step fails here."""
    _need_card()
    from repro_torch.analysis.sentinels import STEP_SYNCS_PER_ROUND, count_syncs
    from repro_torch.simx.state import export_workload

    cfg = SimxConfig(num_workers=256, num_gms=4, num_lms=4, heartbeat_interval=1.0)
    wl = synthetic_trace(num_jobs=20, tasks_per_job=32, load=0.8, num_workers=256, seed=7)
    tasks = export_workload(wl, "cuda")
    rule = runtime.get_rule(name)
    step = rule.build_step(cfg, tasks, runtime.rule_draws(rule, cfg, tasks, 0))
    state = step(runtime.batch_state(rule.init(cfg, tasks)))
    torch.cuda.synchronize()
    rounds = 16
    with count_syncs() as c:
        state = runtime.scan_rounds(step, state, rounds)
    print(f"{name}: {c.count} host syncs in {rounds} rounds")
    assert c.count == STEP_SYNCS_PER_ROUND[name] * rounds


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["megha", "sparrow", "eagle", "pigeon", "oracle"])
def test_stream_segment_host_syncs_are_pinned(name):
    """One stream segment after a refill (``stream._SteadyLoop.segment``)
    makes the pinned syncs of its rounds plus the segment's own
    (``SEGMENT_EXTRA_SYNCS``: the window's upload, the step factory's
    uploads and the one scalar read)."""
    _need_card()
    from repro_torch.analysis.sentinels import (
        SEGMENT_EXTRA_SYNCS,
        STEP_SYNCS_PER_ROUND,
        count_syncs,
    )
    from repro_torch.simx import stream
    from repro_torch.workload.synth import PoissonArrivals, fixed_job_factory

    arr = PoissonArrivals(rate=12.8, job_factory=fixed_job_factory(8, 1.0), seed=7)
    loop = stream._SteadyLoop(name, [arr], 128, devices=(torch.device("cuda"),),
                              window_jobs=48, window_tasks=384, rounds_per_refill=16,
                              horizon=20.0, num_gms=4, num_lms=4)
    loop.refill(loop.segment())
    torch.cuda.synchronize()
    with count_syncs() as c:
        loop.segment()
    print(f"{name}: {c.count} host syncs in a 16-round segment")
    assert c.count == STEP_SYNCS_PER_ROUND[name] * 16 + SEGMENT_EXTRA_SYNCS[name]


# ---------------------------------------------------------------------------
# real-decode serving (``repro_torch.models``, ``launch.serve.ModelRunner``)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen15_05b", "llama3_8b", "gemma_7b", "stablelm_12b",
                                  "llava_next_mistral_7b"])
def test_smoke_decode_on_the_card_matches_the_cpu(arch, dtype, monkeypatch):
    """8 decode steps of the smoke config, B = 2, on the card and on the
    CPU from the same parameters: logits and caches within 2e-4 in fp32
    (TF32 off) and within 0.02 x max(1, |logit|) in bf16 (the CPU tests'
    bf16 bound against the reference)."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import decode as D
    from repro_torch.models import model as M
    from repro_torch.models.schema import init_params, map_tree

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=cdt)
    cpu = init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    card = map_tree(cpu, lambda a: a.cuda())
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    caches = {"cpu": D.init_cache(cfg, 2, 8, "cpu"), "cuda": D.init_cache(cfg, 2, 8, "cuda")}

    def bound(ref):
        return 2e-4 if dtype == "f32" else 0.02 * max(1.0, float(ref.abs().max()))

    for i in range(8):
        want, caches["cpu"] = D.decode_step(cpu, caches["cpu"], {"tokens": toks[:, i:i + 1],
                                                                 "pos": i}, cfg)
        got, caches["cuda"] = D.decode_step(card, caches["cuda"],
                                            {"tokens": toks[:, i:i + 1].cuda(), "pos": i}, cfg)
        assert float((got.cpu() - want).abs().max()) <= bound(want), i
    for k in ("k", "v"):
        ref = caches["cpu"][k].float()
        assert float((caches["cuda"][k].cpu().float() - ref).abs().max()) <= bound(ref), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_smoke_encoder_forward_on_the_card_matches_the_cpu(dtype, monkeypatch):
    """hubert's smoke config (bidirectional, no rope, the frames frontend):
    the encoder forward on a pipeline batch of frames and its chunked-CE
    loss on the card and on the CPU from the same parameters, hidden states
    and loss within 2e-4 in fp32 (TF32 off) and 0.02 x max(1, |value|) in
    bf16."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import batches
    from repro_torch.models import model as M
    from repro_torch.models.schema import init_params, map_tree

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cfg = dataclasses.replace(smoke_config(get_config("hubert_xlarge")), compute_dtype=cdt)
    assert cfg.frontend == "frames" and not cfg.causal and not cfg.use_rope
    cpu = init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    card = map_tree(cpu, lambda a: a.cuda())
    batch = next(batches(cfg, 2, 32, seed=0, device="cpu"))
    on_card = {k: v.cuda() for k, v in batch.items()}

    def bound(ref):
        return 2e-4 if dtype == "f32" else 0.02 * max(1.0, float(ref.abs().max()))

    with torch.no_grad():
        want, got = M.forward(cpu, batch, cfg)[0], M.forward(card, on_card, cfg)[0]
        assert float((got.cpu().float() - want.float()).abs().max()) <= bound(want.float())
        want, got = M.loss_fn(cpu, batch, cfg), M.loss_fn(card, on_card, cfg)
    assert bool(torch.isfinite(want)) and abs(float(got) - float(want)) <= bound(want)


@pytest.mark.gpu
def test_model_runner_tick_makes_no_host_sync():
    """``ModelRunner.tick`` (the serving loop's decode) reads nothing back
    from the card: the position is a host int, the next tokens stay on the
    card."""
    _need_card()
    from repro_torch.analysis.sentinels import count_syncs
    from repro_torch.launch.serve import ModelRunner

    runner = ModelRunner("qwen15_05b", 16, max_len=8)
    runner.tick()
    torch.cuda.synchronize()
    with count_syncs() as c:
        for _ in range(4):
            runner.tick()
    assert c.count == 0, c.sites
    assert runner.pos == 5 and runner.tokens.is_cuda and runner.tokens.dtype == torch.int32
    assert bool(torch.isfinite(runner.logits).all())


# ---------------------------------------------------------------------------
# the MoE, MLA, SSM and hybrid families
# ---------------------------------------------------------------------------

FAMILIES = ("arctic_480b", "deepseek_v2_lite_16b", "mamba2_13b", "zamba2_7b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_on_the_card_matches_the_cpu(arch, monkeypatch):
    """forward and 8 decode steps of the smoke config in fp32 (TF32 off),
    B = 2, on the card and on the CPU from the same parameters (the fp32
    norms, decays and biases moved off their init): hidden states, logits
    and every cache within 2e-4; the MoE's routing equal on both sides
    (capacity factor 16: nothing dropped)."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import decode as D
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.schema import init_params, map_tree

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=torch.float32)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    gen = torch.Generator().manual_seed(1)

    def perturbed(tree):
        return {k: perturbed(v) if isinstance(v, dict) else
                v + 0.1 * torch.randn(v.shape, generator=gen) if k in M.FP32_READ else v
                for k, v in tree.items()}

    cpu = perturbed(init_params(M.model_schema(cfg), gen, "cpu"))
    card = map_tree(cpu, lambda a: a.cuda())
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    routes = {"cpu": [], "cuda": []}
    route = MOE.route

    def spy(params, xg, c):
        out = route(params, xg, c)
        routes[xg.device.type].append(out[2].cpu())
        return out

    monkeypatch.setattr(MOE, "route", spy)
    want = M.forward(cpu, {"tokens": toks}, cfg)[0]
    got = M.forward(card, {"tokens": toks.cuda()}, cfg)[0]
    assert float((got.cpu() - want).abs().max()) <= 2e-4
    caches = {"cpu": D.init_cache(cfg, 2, 8, "cpu"), "cuda": D.init_cache(cfg, 2, 8, "cuda")}
    for i in range(8):
        want, caches["cpu"] = D.decode_step(cpu, caches["cpu"], {"tokens": toks[:, i:i + 1],
                                                                 "pos": i}, cfg)
        got, caches["cuda"] = D.decode_step(card, caches["cuda"],
                                            {"tokens": toks[:, i:i + 1].cuda(), "pos": i}, cfg)
        assert float((got.cpu() - want).abs().max()) <= 2e-4, i
    for k, ref in caches["cpu"].items():
        assert float((caches["cuda"][k].cpu().float() - ref.float()).abs().max()) <= 2e-4, k
    n_moe = cfg.num_layers - cfg.moe.first_k_dense if cfg.moe else 0
    assert len(routes["cpu"]) == len(routes["cuda"]) == 9 * n_moe
    assert all(torch.equal(a.sort(-1).values, b.sort(-1).values)
               for a, b in zip(routes["cpu"], routes["cuda"]))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_runner_tick_makes_no_host_sync(arch):
    """``ModelRunner.tick`` reads nothing back from the card for the MoE,
    MLA, SSM and hybrid families either: the routing, the dispatch and
    every in-place cache write stay on the card."""
    _need_card()
    from repro_torch.analysis.sentinels import count_syncs
    from repro_torch.launch.serve import ModelRunner

    runner = ModelRunner(arch, 16, max_len=8)
    runner.tick()
    torch.cuda.synchronize()
    with count_syncs() as c:
        for _ in range(4):
            runner.tick()
    assert c.count == 0, c.sites
    assert runner.pos == 5 and bool(torch.isfinite(runner.logits).all())


# ---------------------------------------------------------------------------
# training (``repro_torch.train``, ``repro_torch.data``)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen15_05b", "deepseek_v2_lite_16b", "zamba2_7b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(arch, monkeypatch):
    """One train step of the smoke config in fp32 (TF32 off, remat "full",
    AdamW at lr 1e-2 with no warmup) on the card and on the CPU from the
    same parameters and pipeline batch: loss and grad norm within 2e-4 x
    max(1, |value|), both moments (0.1 x the clipped gradient and 0.05 x
    its square) within 1e-3 x the leaf's largest, and the step (p0 - p) /
    lr within 0.01 plus one fp32 rounding of the parameter wherever the
    first moment is above that bound (a first AdamW step moves a parameter
    by lr x (sign(g) + wd x p), so where a gradient is zero up to rounding
    its sign may differ); the step makes no host sync."""
    _need_card()
    import dataclasses

    from repro_torch.analysis.sentinels import count_syncs
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import batches
    from repro_torch.models import model as M
    from repro_torch.models.schema import init_params, map_tree, tree_items
    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as O

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=torch.float32,
                              remat=True)
    opt = O.OptConfig(lr=1e-2, warmup_steps=1)
    params = init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    batch = next(batches(cfg, 2, 32, seed=1, device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda a, dev=dev: a.to(dev, copy=True))
        state = {"params": p, "opt": O.init_opt_state(p, opt)}
        step = TL.make_train_step(cfg, opt)
        b = {k: v.to(dev) for k, v in batch.items()}
        if dev == "cuda":
            step(map_tree(state, lambda a: a.clone()), b)  # warm
            torch.cuda.synchronize()
            with count_syncs() as c:
                state, m = step(state, b)
            assert c.count == 0, c.sites
        else:
            state, m = step(state, b)
        out[dev] = state, m
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(cm[k])) <= 2e-4 * max(1.0, abs(float(cm[k]))), k
    assert int(gm["step"]) == 1
    stepped = 0
    for path, p0 in tree_items(params):
        want = {k: dict(tree_items(t))[path].float() for k, t in (
            ("p", cs["params"]), ("m", cs["opt"]["m"]), ("v", cs["opt"]["v"]))}
        got = {k: dict(tree_items(t))[path].cpu().float() for k, t in (
            ("p", gs["params"]), ("m", gs["opt"]["m"]), ("v", gs["opt"]["v"]))}
        for k in ("m", "v"):
            assert float((got[k] - want[k]).abs().max()) <= 1e-3 * float(want[k].abs().max()), \
                (k, path)
        sel = want["m"].abs() > max(1e-3 * float(want["m"].abs().max()), 1e-7)
        err = (got["p"][sel] - want["p"][sel]).abs() / opt.lr
        slack = 0.01 + torch.finfo(p0.dtype).eps * torch.maximum(
            p0.float()[sel].abs(), want["p"][sel].abs()) / opt.lr
        assert bool((err <= slack).all()), (path, float(err.max()))
        stepped += int(sel.sum())
    assert stepped > 0


@pytest.mark.gpu
def test_checkpoint_round_trip_from_card_tensors(tmp_path):
    """A train state on the card (fp32 parameters, bf16 moments, an int32
    step) saved and restored onto the card bitwise, in its dtypes."""
    _need_card()
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.schema import tree_items
    from repro_torch.train import checkpoint as C
    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as O

    cfg = smoke_config(get_config("qwen15_05b"))
    opt = O.OptConfig(moment_dtype=torch.bfloat16)
    state = TL.init_train_state(cfg, opt, torch.Generator(device="cuda").manual_seed(0))
    for _, m in tree_items(state["opt"]["m"]):
        m.normal_()
    C.save(tmp_path, state, step=2)
    back = C.restore(tmp_path, 2, like=state)
    for (path, a), (_, b) in zip(tree_items(state), tree_items(back)):
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the dry run (``repro_torch.launch.dryrun``): the meta count is the card's
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen15_05b", "deepseek_v2_lite_16b", "mamba2_13b",
                                  "zamba2_7b", "arctic_480b"])
def test_card_flop_count_equals_the_meta_trace(arch):
    """``FlopCounterMode`` over a smoke decode step and a smoke train step
    run on the card (real weights, cache and batch) counts exactly what
    the dry run counts over the same steps traced on the meta device."""
    _need_card()
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeCell, get_config, smoke_config
    from repro_torch.data.pipeline import batches
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode as D
    from repro_torch.models import model as M
    from repro_torch.models.schema import init_params
    from repro_torch.train import loop as TL

    cfg = dataclasses.replace(smoke_config(get_config(arch)), loss_chunk=16, remat=True)
    mesh = make_host_mesh()
    b, t = 4, 32
    params = init_params(M.model_schema(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    cache = D.init_cache(cfg, b, t, "cuda")
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        D.decode_step(params, cache, {"tokens": torch.ones((b, 1), dtype=torch.int32,
                                                           device="cuda"), "pos": 3}, cfg)
    meta, _ = DR.trace_cell(cfg, ShapeCell("d", "decode", t, b), mesh)
    assert fc.get_total_flops() == meta.get_total_flops() > 0
    opt = DR._opt_for(cfg)
    state = {"params": params, "opt": TL.O.init_opt_state(params, opt)}
    batch = next(batches(cfg, b, t, seed=0, device="cuda"))
    with FlopCounterMode(display=False) as fc:
        TL.make_train_step(cfg, opt)(state, batch)
    meta, _ = DR.trace_cell(cfg, ShapeCell("t", "train", t, b), mesh)
    assert fc.get_total_flops() == meta.get_total_flops() > 0
