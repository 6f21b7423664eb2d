"""The task-axis pass of the sparrow and eagle rules
(``repro_torch.kernels.tasks.task_scan`` and its plain version in
``kernels/ref.py``) and the late binding that reads its list, on the CPU.

The specification is the formulation the rules ran before the pass: per-job
counts by ``scatter_add`` over the task axis (``spec_counts``), and late
binding through a ``[*P, T]`` slot table filled by a scatter from the
within-job pending ranks (``slot_late_bind``), both kept here as they were.
The plain ``task_scan`` equals the counts, and its list is each row's
pending tasks in ascending order; ``sparrow.late_bind`` over the counts and
the list equals ``slot_late_bind`` over the pending mask.  The cases cover
empty jobs, pad tasks of job J at the end, lane-stacked job rows, rows with
nothing or everything pending, finish and submit times equal to ``t``, an
unbatched row, and (for the counts alone) jobs in no order.  The streaming
engine's lane-stacked windows keep each lane's tasks in job order, which
the list lookup relies on.  The CUDA kernel is held against the same plain
version on the card (``test_torch_gpu.py``)."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.tasks import task_scan
from repro_torch.simx import runtime as rt
from repro_torch.simx import sparrow, stream
from repro_torch.workload.synth import PoissonArrivals

J, B, W = 9, 3, 20
#: the case kinds: jobs in job-id order (the list lookup's precondition)
#: and, for the counts alone, jobs in no order
SORTED_KINDS = ("random", "pad", "lanes", "unbatched", "none_pending", "all_pending",
                "boundary")
KINDS = SORTED_KINDS + ("unsorted",)
SEEDS = (0, 1, 2, 3, 4)


def spec_counts(fin, submit, job, t, num_jobs):
    """The per-job counts as the steps built them: ``unfinished_jobs``'
    scatter_add of ``task_finish > t`` and the dispatch's scatter_add of
    the pending mask, into ``[*P, J + 1]``; and the pending mask."""
    lead, T = fin.shape[:-1], fin.shape[-1]
    idx = job.to(torch.int64).expand(lead + (T,))
    tt = rt.lift(t, fin)
    unfinished = torch.zeros(lead + (num_jobs + 1,), dtype=torch.int32).scatter_add(
        -1, idx, (fin > tt).to(torch.int32))
    pend = torch.isinf(fin) & (submit <= tt)
    pending = torch.zeros(lead + (num_jobs + 1,), dtype=torch.int32).scatter_add(
        -1, idx, pend.to(torch.int32))
    return unfinished, pending, pend


def slot_late_bind(job_pick, pend_task, job, job_start):
    """Late binding as the rules ran it before the list: within-job pending
    ranks from one scan, a ``[*P, T]`` slot table filled by a scatter (tasks
    that are not pending write the pad slot T, cut off), then each serving
    worker's slot."""
    T, J_ = job.shape[-1], job_start.shape[-1]
    lead = pend_task.shape[:-1]
    job64 = job.to(torch.int64)
    at = rt.take if job.dim() > 1 else (lambda src, idx: src[..., idx])
    pend_i = pend_task.to(torch.int32)
    pending = torch.zeros(lead + (J_,), dtype=torch.int32).scatter_add(
        -1, job64.expand(lead + (T,)), pend_i)
    c = ref.scan_rows(pend_i)
    base = torch.where(job_start > 0, at(c, torch.clamp(job_start - 1, min=0).to(torch.int64)),
                       0)
    prank = c - 1 - at(base, job64)
    dest = torch.where(pend_task, rt.take(job_start, job64) + prank, T).to(torch.int64)
    t_row = torch.arange(T, dtype=torch.int32).expand(lead + (T,))
    slot = torch.full(lead + (T + 1,), T, dtype=torch.int32).scatter(-1, dest, t_row)[..., :T]
    _, rank = sparrow._rank_within_groups(job_pick)
    jp = torch.clamp(job_pick, 0, J_ - 1)
    serve = (job_pick < J_) & (rank < rt.take(pending, jp))
    pos = rt.take(job_start, jp) + rank
    return serve, torch.where(serve, rt.take(slot, torch.clamp(pos, 0, T - 1)), T)


def _job_row(rng, pad: int = 0) -> np.ndarray:
    """Jobs of 0-8 tasks in job-id order (some empty), then ``pad`` tasks
    of the pad job J."""
    while True:
        sizes = rng.integers(0, 9, J)
        if sizes.sum():
            break
    return np.concatenate([np.repeat(np.arange(J), sizes), np.full(pad, J)]).astype(np.int32)


def _case(kind: str, seed: int):
    """``(task_finish, submit, job, t)`` of one kind."""
    rng = np.random.default_rng(1000 * KINDS.index(kind) + seed)
    lead = () if kind == "unbatched" else (B,)
    if kind == "lanes":
        rows = [_job_row(rng) for _ in range(B)]
        T = max(r.size for r in rows) + 2
        job = np.stack([np.concatenate([r, np.full(T - r.size, J)]) for r in rows])
    else:
        job = _job_row(rng, pad=3 if kind == "pad" else 0)
        if kind == "unsorted":
            job = rng.permutation(job)
        T = job.size
    t = np.asarray(rng.uniform(1, 3, lead), dtype=np.float32)
    fin = rng.uniform(0, 4, lead + (T,)).astype(np.float32)
    fin[rng.random(fin.shape) < 0.45] = np.inf
    submit = rng.uniform(0, 4, lead + (T,)).astype(np.float32)
    if kind == "random":
        submit = submit[0] if lead else submit     # one row for every point
    elif kind == "none_pending":
        fin = np.where(np.isinf(fin), np.float32(5.0), fin)
    elif kind == "all_pending":
        fin[...] = np.inf
        submit[...] = 0.0
    elif kind == "boundary":
        tt = np.broadcast_to(t[..., None], fin.shape)
        fin = np.where(rng.random(fin.shape) < 0.4, tt, fin).astype(np.float32)
        submit = np.where(rng.random(fin.shape) < 0.5, tt, submit).astype(np.float32)
    return (torch.from_numpy(fin), torch.from_numpy(np.ascontiguousarray(submit)),
            torch.from_numpy(job), torch.from_numpy(t))


def _job_start(job: torch.Tensor, num_jobs: int) -> torch.Tensor:
    """int32[..., num_jobs] — each job's first task of a job-ordered row."""
    j = torch.arange(num_jobs, dtype=job.dtype).expand(job.shape[:-1] + (num_jobs,))
    return torch.searchsorted(job.contiguous(), j.contiguous()).to(torch.int32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_task_scan_plain_is_the_scatter_formulation(kind, seed):
    fin, submit, job, t = _case(kind, seed)
    unfinished, pending, plist = task_scan(fin, submit, job, t, J)
    want_u, want_p, pend = spec_counts(fin, submit, job, t, J)
    assert unfinished.dtype == pending.dtype == plist.dtype == torch.int32
    assert torch.equal(unfinished, want_u) and torch.equal(pending, want_p)
    T = fin.shape[-1]
    assert plist.shape == fin.shape
    for row, mask in zip(plist.reshape(-1, T), pend.reshape(-1, T)):
        n = int(mask.sum())
        assert torch.equal(row[:n], torch.nonzero(mask).flatten().to(torch.int32))
        assert bool((row[n:] == T).all())     # the plain version's tail
    # submit=None: the unfinished counts alone, those of ``unfinished_jobs``
    alone = task_scan(fin, None, job, t, J)
    assert torch.equal(alone[0], want_u) and alone[1:] == (None, None)
    assert torch.equal(sparrow.unfinished_jobs(fin, job, t, J), want_u)
    if kind == "none_pending":
        assert int(pending.sum()) == 0
    if kind == "all_pending":
        assert int(pending.sum()) == fin.numel()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", SORTED_KINDS)
def test_late_bind_from_the_list_is_the_slot_table(kind, seed):
    """Picks in [0, J] (J = no claim), several workers a job so that some
    exceed its pending count.  With pad tasks, the slot formulation takes
    the pad job as one more job that no worker picks."""
    fin, submit, job, t = _case(kind, seed)
    _, pending, plist = task_scan(fin, submit, job, t, J)
    _, _, pend = spec_counts(fin, submit, job, t, J)
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.integers(0, J + 1, fin.shape[:-1] + (W,)).astype(np.int32))
    got = sparrow.late_bind(pick, pending, plist)
    has_pad = bool((job == J).any())
    jobs = J + 1 if has_pad else J
    want = slot_late_bind(torch.where(pick == J, jobs, pick), pend, job,
                          _job_start(job, jobs))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[0].any()) or int(pending[..., :J].sum()) == 0


def _random_sizes(rng, i):
    del i
    return [1.0] * rng.randint(1, 12)


def test_stream_lanes_keep_each_lane_in_job_order():
    """Three lanes of sparrow's streaming engine, refilled a few times:
    every lane's window lists its tasks in non-decreasing job order (the
    pad job, which owns the spare slots, last), and each job's pending
    tasks are the entries of the pending list that ``late_bind`` reads for
    it."""
    arrivals = [PoissonArrivals(rate=r, job_factory=_random_sizes, seed=s, num_jobs=40)
                for r, s in ((4.0, 1), (6.0, 2), (8.0, 3))]
    loop = stream._SteadyLoop("sparrow", arrivals, 32, devices=(torch.device("cpu"),),
                              window_jobs=12, window_tasks=96, rounds_per_refill=8,
                              horizon=12.0)
    checked = 0
    while not loop.done and checked < 8:
        seg = loop.segment()
        tasks = stream._stack_tasks([loop.wins[i] for i in loop.order], torch.device("cpu"))
        job, state = tasks.job, seg["state"]
        assert job.dim() == 2 and job.shape[0] == 3
        assert bool((job[:, 1:] >= job[:, :-1]).all())
        n_jobs = tasks.num_jobs
        _, pending, plist = task_scan(state.task_finish, tasks.submit, job, state.t, n_jobs)
        before = torch.cumsum(pending, -1, dtype=torch.int32) - pending
        for b in range(3):
            for j in range(n_jobs):
                p0, n = int(before[b, j]), int(pending[b, j])
                assert bool((job[b, plist[b, p0:p0 + n].long()] == j).all())
        checked += int(pending.sum() > 0)
        loop.refill(seg)
    assert checked > 0


@pytest.mark.parametrize("bad", ["finish_dtype", "t_shape", "device"])
def test_task_scan_refuses_what_it_does_not_take(bad):
    fin, submit, job, t = _case("random", 0)
    if bad == "finish_dtype":
        with pytest.raises(TypeError, match="float32"):
            task_scan(fin.double(), submit, job, t, J)
    elif bad == "t_shape":
        with pytest.raises(ValueError, match="t must be"):
            task_scan(fin, submit, job, t[:1], J)
    else:
        with pytest.raises(ValueError, match="no kernel for device"):
            task_scan(fin.to("meta"), None, job.to("meta"), t.to("meta"), J)


def test_late_bind_serves_no_more_than_pending():
    """Every worker picks job 0, which has two pending tasks: the first two
    workers (in worker order) get them, in task order."""
    fin = torch.tensor([[math.inf, 1.0, math.inf, math.inf]])
    submit = torch.tensor([[0.0, 0.0, 0.0, 5.0]])
    job = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    t = torch.tensor([2.0])
    _, pending, plist = task_scan(fin, submit, job, t, 2)
    assert pending.tolist() == [[2, 0, 0]]
    launch, task = sparrow.late_bind(torch.zeros((1, 4), dtype=torch.int32), pending, plist)
    assert launch.tolist() == [[True, True, False, False]]
    assert task.tolist() == [[0, 2, 4, 4]]
