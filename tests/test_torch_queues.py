"""The reservation-queue passes of the port (``repro_torch.kernels.queues``
and their plain versions in ``kernels/ref.py``) against the JAX reference
on the CPU.

The plain versions, composed as the sparrow and eagle steps compose them
(compaction, then the active mask with the jobs holding a reservation,
then the n = 1 pick and the head), equal the reference's
``compact_queues``, its active mask, ``jobs_with_reservation`` and
``queue_head_pick`` point by point: at R in {8, 16, 40, 64}, unbatched,
over a point axis and lane-stacked (one job row per point), with and
without the row mask and the dead workers, and on queues all empty and
all full.  The insertion into compaction's buffer, in place, equals the
reference's insertion.  The CUDA kernels are held against the same plain
versions on the card (``test_torch_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simx import faults as jax_faults
from repro.simx import runtime as jax_rt
from repro.simx import sparrow as jax_sparrow
from repro_torch.kernels import queues, ref
from repro_torch.simx import sparrow

W, J, T, B = 24, 70, 200, 3


def _queues(rng, lead, R, kind="random"):
    """Queues as a round finds them: each row ascending distinct job ids,
    then J; ``kind`` "empty" or "full" fills no slot or every one."""
    rows = int(np.prod(lead, dtype=np.int64)) * W
    resq = np.full((rows, R), J, np.int32)
    for i in range(rows):
        n = {"empty": 0, "full": R}.get(kind, int(rng.integers(0, R + 1)))
        resq[i, :n] = np.sort(rng.choice(J, n, replace=False))
    return resq.reshape(tuple(lead) + (W, R))


def _case(rng, layout, R, kind="random"):
    """Per point: queues, task finish times, the job of each task (shared,
    or one row per point when lane-stacked), the time, pending tasks per
    job (the step's ``[*P, J + 1]`` table), idle and dead workers."""
    lead = () if layout == "unbatched" else (B,)
    resq = _queues(rng, lead, R, kind)
    fin = rng.uniform(0, 4, lead + (T,)).astype(np.float32)
    fin[rng.random(fin.shape) < 0.3] = np.inf
    if layout == "lanes":
        job = np.sort(rng.integers(0, J, (B, T)), axis=-1).astype(np.int32)
    else:
        job = np.sort(rng.integers(0, J, T)).astype(np.int32)
    t = rng.uniform(1, 3, lead).astype(np.float32)
    pending = rng.integers(0, 3, lead + (J + 1,)).astype(np.int32)
    pending[..., J] = 0
    pending[..., :J][..., rng.random(J) < 0.3] = 0
    idle = rng.random(lead + (W,)) < 0.6
    dead = rng.random(lead + (W,)) < 0.25
    return resq, fin, job, t, pending, idle, dead


def _points(layout):
    return [()] if layout == "unbatched" else [(b,) for b in range(B)]


def _job_row(job, layout, p):
    return job[p] if layout == "lanes" else job


def _check_composed(resq, fin, job, t, pending, idle, dead, layout, R, masks):
    row_mask = idle if masks in ("row_mask", "both") else None
    dead_w = dead if masks in ("dead", "both") else None
    T_ = torch.from_numpy
    unfinished = sparrow.unfinished_jobs(T_(fin), T_(job), T_(t), J)
    out, fill = ref.queue_compact_ref(T_(resq), unfinished)
    out = out.contiguous()
    active, has_res = ref.queue_scan_ref(
        out, T_(pending), None if row_mask is None else T_(row_mask),
        None if dead_w is None else T_(dead_w))
    rows = active.reshape(-1, R)
    ranks = ref.match_ranks_batched_ref(rows, torch.ones(rows.shape[0], dtype=torch.int32))
    head = ref.queue_head_ref(out, ranks, J)
    # the wrappers take the plain versions on the CPU
    buf, fill_w = queues.queue_compact(T_(resq), unfinished)
    assert buf.shape == (resq.size + 1,) and int(buf[-1]) == J
    assert torch.equal(buf[:-1].view(resq.shape), out) and torch.equal(fill_w, fill)
    active_w, has_res_w = queues.queue_scan(
        out, T_(pending), None if row_mask is None else T_(row_mask),
        None if dead_w is None else T_(dead_w))
    assert torch.equal(active_w, active) and torch.equal(has_res_w, has_res)
    assert torch.equal(queues.queue_head(out, ranks, J), head)

    match_fn = jax_rt.default_match_fn()
    for p in _points(layout):
        jq, jfill = jax_sparrow.compact_queues(
            jnp.asarray(resq[p]), jnp.asarray(fin[p]), jnp.asarray(_job_row(job, layout, p)),
            jnp.asarray(t[p]), J)
        np.testing.assert_array_equal(out[p].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(fill[p].numpy(), np.asarray(jfill))
        jpend = jnp.asarray(pending[p])
        jactive = (jq < J) & (jpend[jnp.minimum(jq, J)] > 0)
        if row_mask is not None:
            jactive = jactive & jnp.asarray(row_mask[p])[:, None]
        np.testing.assert_array_equal(active[p].numpy(), np.asarray(jactive))
        jdead = None if dead_w is None else jnp.asarray(dead_w[p])
        np.testing.assert_array_equal(
            has_res[p].numpy(), np.asarray(jax_faults.jobs_with_reservation(jq, J, dead=jdead)))
        np.testing.assert_array_equal(
            head[p].numpy(), np.asarray(jax_sparrow.queue_head_pick(jq, jactive, match_fn, J)))
    return out, active, has_res, head


@pytest.mark.parametrize("masks", ["none", "row_mask", "dead", "both"])
@pytest.mark.parametrize("layout", ["unbatched", "batched", "lanes"])
@pytest.mark.parametrize("R", [8, 16, 40, 64])
def test_plain_queue_passes_compose_to_the_reference(R, layout, masks):
    rng = np.random.default_rng(R * 31 + len(layout) * 7 + len(masks))
    out, active, has_res, head = _check_composed(*_case(rng, layout, R), layout, R, masks)
    # the case is not trivial: some entries recycled, some active, some heads
    assert bool((head < J).any()) and bool(active.any()) and bool(has_res.any())


@pytest.mark.parametrize("kind", ["empty", "full"])
@pytest.mark.parametrize("R", [8, 16, 40, 64])
def test_plain_queue_passes_on_empty_and_full_queues(R, kind):
    rng = np.random.default_rng(R + len(kind))
    out, active, has_res, head = _check_composed(
        *_case(rng, "batched", R, kind), "batched", R, "both")
    if kind == "empty":
        assert not bool(active.any()) and not bool(has_res.any()) and bool((head == J).all())
        assert bool((out == J).all())


@pytest.mark.parametrize("layout", ["unbatched", "batched"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insertion_in_place_equals_the_reference(layout, seed):
    """``insert_probes(..., buf=)`` into compaction's buffer, in place,
    gives the reference's queues and overflow counts point by point
    (merges and drops included), as the copying call does, and leaves the
    queues it started from as they were."""
    rng = np.random.default_rng(seed)
    lead = () if layout == "unbatched" else (B,)
    R, C = 4, 40
    resq = _queues(rng, lead, R)
    fill = (resq < J).sum(-1).astype(np.int32)
    jobs = np.sort(rng.integers(J // 2 - 1, J, lead + (C,)), axis=-1).astype(np.int32)
    targets = rng.integers(0, W // 2, lead + (C,)).astype(np.int32)
    ins = np.arange(C) < rng.integers(C // 2, C + 1, lead + (1,))
    args = [torch.from_numpy(a) for a in (fill, targets, jobs, ins)]
    copied, copied_over = sparrow.insert_probes(torch.from_numpy(resq), *args)
    # every job unfinished: compaction keeps each queue as it is
    start = torch.from_numpy(resq)
    buf, fill_c = queues.queue_compact(start, torch.ones(lead + (J + 1,), dtype=torch.int32))
    view = buf[:-1].view(start.shape)
    assert torch.equal(view, start) and torch.equal(fill_c, args[0])
    got, got_over = sparrow.insert_probes(view, *args, buf=buf)
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(got, copied) and torch.equal(got_over, copied_over)
    for p in _points(layout):
        want, want_over = jax_sparrow.insert_probes(
            *(jnp.asarray(a[p]) for a in (resq, fill, targets, jobs, ins)))
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_over[p].numpy(), np.asarray(want_over))
    assert int(got_over.sum()) > 0 and not torch.equal(got, start)
    assert torch.equal(start, torch.from_numpy(resq))


def test_wrappers_check_their_inputs():
    resq = torch.full((2, 5, 4), J, dtype=torch.int32)
    table = torch.zeros((2, J + 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        queues.queue_compact(resq.to(torch.int64), table)
    with pytest.raises(ValueError):
        queues.queue_compact(resq, table[:1])
    with pytest.raises(ValueError):
        queues.queue_scan(resq.transpose(0, 1), torch.zeros((5, J + 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        queues.queue_scan(resq, table, row_mask=torch.ones((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        queues.queue_head(resq, torch.zeros(7, dtype=torch.int32), J)
    # the plain versions take any width; only the kernels stop at MAX_LANES
    wide = torch.full((1, 3, queues.MAX_LANES + 1), J, dtype=torch.int32)
    buf, fill = queues.queue_compact(wide, torch.ones((1, J + 1), dtype=torch.int32))
    assert bool((buf == J).all()) and not bool(fill.any())
    before = (queues.queue_compact.launches, queues.queue_scan.launches,
              queues.queue_head.launches)
    queues.queue_scan(resq, table)
    assert (queues.queue_compact.launches, queues.queue_scan.launches,
            queues.queue_head.launches) == before
