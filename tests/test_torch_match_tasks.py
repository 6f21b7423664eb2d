"""The port's single-row match and the LM-side ops (``repro_torch.kernels``
``ref``/``match``/``ops``) against the JAX reference, bitwise, on
numpy-seeded inputs; the reference's properties of these ops
(``tests/test_kernels.py``) on the port; and the worker-0 scatter quirk the
port mirrors.  The CUDA kernel itself is held against its plain version on
the card in ``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.match import match_ranks as pallas_match_ranks
from repro_torch.kernels import match, ops, ref

SEEDS = list(range(8))
#: widths drawn per seed: a few shapes, so the reference compiles few times
WIDTHS = [1, 7, 64, 300, 1024]
DTYPES = {
    "int8": (np.int8, torch.int8),
    "int32": (np.int32, torch.int32),
    "bool": (np.bool_, torch.bool),
}


def _row(seed: int, dtype: str = "bool"):
    """A 0/1 availability row, its width and a count n in [0, w + 7]."""
    rng = np.random.default_rng(seed)
    w = WIDTHS[seed % len(WIDTHS)]
    avail = (rng.random(w) < rng.uniform(0.1, 0.9)).astype(DTYPES[dtype][0])
    n = int(rng.integers(0, w + 8))
    return avail, w, n


def _assignment(seed: int, w: int, t: int) -> np.ndarray:
    """T worker ids in [-1, w), with repeats."""
    return np.random.default_rng(seed + 1000).integers(-1, w, t).astype(np.int32)


def _truth(seed: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed + 2000).random(w) < 0.6


# ---------------------------------------------------------------------------
# plain versions and ops, bitwise against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_match_ranks_ref_matches_reference(seed, dtype):
    avail, _, n = _row(seed, dtype)
    got = ref.match_ranks_ref(torch.from_numpy(avail), n)
    assert got.dtype == torch.int32
    want = jax_ref.match_ranks_ref(jnp.asarray(avail), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_match_tasks_ref_matches_reference(seed):
    """Also with n above max_tasks, where the reference's scatter drops the
    ranks past the end and the port's sentinel slot takes them."""
    avail, w, n = _row(seed)
    for max_tasks in (1, 16, w):
        got_a, got_p = ref.match_tasks_ref(torch.from_numpy(avail), n, max_tasks)
        want_a, want_p = jax_ref.match_tasks_ref(jnp.asarray(avail), n, max_tasks)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        assert got_a.dtype == torch.int32 and got_p.dtype == torch.int32
        assert int(got_p) == int(want_p)


@pytest.mark.parametrize("seed", SEEDS)
def test_verify_ref_matches_reference(seed):
    _, w, _ = _row(seed)
    truth, asg = _truth(seed, w), _assignment(seed, w, 32)
    got = ref.verify_ref(torch.from_numpy(truth), torch.from_numpy(asg))
    want = jax_ref.verify_ref(jnp.asarray(truth), jnp.asarray(asg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["wrapper", "plain"])
@pytest.mark.parametrize("seed", SEEDS)
def test_ops_match_tasks_matches_reference(seed, use_kernel):
    avail, w, n = _row(seed)
    max_tasks = 64
    want_a, want_p = jax_ops.match_tasks(jnp.asarray(avail), n, max_tasks, use_pallas=False)
    for count in (n, torch.tensor(n, dtype=torch.int32)):
        got_a, got_p = ops.match_tasks(
            torch.from_numpy(avail), count, max_tasks, use_kernel=use_kernel)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        assert got_p.dtype == torch.int32 and int(got_p) == int(want_p)


@pytest.mark.parametrize("seed", SEEDS)
def test_verify_and_commit_matches_reference(seed):
    _, w, _ = _row(seed)
    truth, asg = _truth(seed, w), _assignment(seed, w, 48)
    got_t, got_v = ops.verify_and_commit(torch.from_numpy(truth), torch.from_numpy(asg))
    want_t, want_v = jax_ops.verify_and_commit(jnp.asarray(truth), jnp.asarray(asg))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("seed", SEEDS)
def test_release_matches_reference(seed):
    _, w, _ = _row(seed)
    truth, workers = _truth(seed, w), _assignment(seed, w, 48)
    got = ops.release(torch.from_numpy(truth), torch.from_numpy(workers))
    want = jax_ops.release(jnp.asarray(truth), jnp.asarray(workers))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1024, 8192])
def test_pallas_single_row_kernel_matches_plain_version(w):
    """The TPU kernel itself, in interpret mode, against the port's plain
    version (the CUDA kernel's yardstick on the card)."""
    rng = np.random.default_rng(w)
    avail = (rng.random(w) < 0.4).astype(np.int8)
    for n in (0, 1, w // 2, w, w + 7):
        got = ref.match_ranks_ref(torch.from_numpy(avail), n)
        want = pallas_match_ranks(jnp.asarray(avail), n, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_kernels.py) on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_match_semantics_property(seed):
    """Ranks are exactly 0..K-1 over the first K free workers, K=min(n,#free)."""
    avail, _, n = _row(seed, "int8")
    ranks = ref.match_ranks_ref(torch.from_numpy(avail), n).numpy()
    taken = ranks[ranks >= 0]
    k = min(n, int(avail.sum()))
    assert sorted(taken.tolist()) == list(range(k))
    np.testing.assert_array_equal(np.flatnonzero(ranks >= 0), np.flatnonzero(avail)[:k])


@pytest.mark.parametrize("seed", SEEDS)
def test_verify_commit_properties(seed):
    """No double-booking; conservation; invalid tasks change nothing."""
    rng = np.random.default_rng(seed)
    w, t = int(rng.integers(4, 300)), int(rng.integers(1, 64))
    truth = torch.from_numpy(rng.random(w) < 0.6)
    a = rng.integers(-1, w, t).astype(np.int32)
    new_truth, valid = ops.verify_and_commit(truth, torch.from_numpy(a))
    v = valid.numpy()
    granted = a[v]
    assert len(set(granted.tolist())) == len(granted)
    assert all(bool(truth[x]) and not bool(new_truth[x]) for x in granted)
    assert int(truth.sum()) - int(new_truth.sum()) == int(v.sum())
    assert not v[a < 0].any()


def test_match_tasks_inverse_scatter():
    avail = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int8)
    out, placed = ops.match_tasks(avail, 3, 4, use_kernel=False)
    np.testing.assert_array_equal(out.numpy(), [0, 2, 3, -1])
    assert int(placed) == 3


# ---------------------------------------------------------------------------
# the reference's clip-then-last-writer-wins scatter, mirrored
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers,freed", [([0, -1], False), ([-1, 0], True)])
def test_release_worker_zero_quirk_matches_reference(workers, freed):
    """A -1 after worker 0 clips to 0 and writes its old (busy) value back
    last; a -1 before it is overwritten.  The port keeps that outcome."""
    w = np.asarray(workers, np.int32)
    got = ops.release(torch.zeros(8, dtype=torch.bool), torch.from_numpy(w))
    want = jax_ops.release(jnp.zeros(8, bool), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got[0]) is freed


@pytest.mark.parametrize("seed", SEEDS)
def test_set_last_writer_wins_is_in_order_scatter(seed):
    rng = np.random.default_rng(seed)
    dst = rng.random(16) < 0.5
    idx = rng.integers(0, 16, 24)
    val = rng.random(24) < 0.5
    want = dst.copy()
    for i, x in zip(idx, val):  # entry order: the last write stays
        want[i] = x
    got = ops.set_last_writer_wins(
        torch.from_numpy(dst), torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_run_plain_version_without_launching():
    avail, w, n = _row(4)
    a = torch.from_numpy(avail)
    before = (match.match_ranks.launches, match.match_tasks.launches)
    assert torch.equal(match.match_ranks(a, n), ref.match_ranks_ref(a, n))
    got = match.match_tasks(a, n, 16)
    want = ref.match_tasks_ref(a, min(n, 16), 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (match.match_ranks.launches, match.match_tasks.launches) == before


@pytest.mark.parametrize(
    "avail,n,err",
    [
        (torch.ones(2, 8, dtype=torch.bool), 1, ValueError),
        (torch.ones(8, dtype=torch.float32), 1, TypeError),
        (torch.ones(16, dtype=torch.bool)[::2], 1, ValueError),
        (torch.ones(8, dtype=torch.bool), torch.ones(1, dtype=torch.int64), ValueError),
        (torch.ones(8, dtype=torch.bool), torch.ones(2, dtype=torch.int32), ValueError),
        (torch.ones(8, dtype=torch.bool), 1.5, TypeError),
    ],
    ids=["2d", "float", "non-contiguous", "n-int64", "n-shape", "n-float"],
)
def test_wrappers_reject_bad_input(avail, n, err):
    with pytest.raises(err):
        match.match_ranks(avail, n)
    with pytest.raises(err):
        match.match_tasks(avail, n, 4)
