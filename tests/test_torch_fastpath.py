"""The port's Megha fast path (``repro_torch.core.fastpath``) against the
JAX reference (``repro.core.fastpath``, ``use_pallas=False``), bitwise on
numpy-seeded states, plus the reference's conservation property
(``tests/test_kernels.py::test_gm_round_conservation``) on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as JFP
from repro_torch.core import fastpath as FP

SEEDS = list(range(6))
W, G, L = 256, 4, 4


def _state(seed: int):
    rng = np.random.default_rng(seed)
    return rng.random(W) < 0.7, rng.random(W) < 0.7


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_round_equal(got, want) -> None:
    for name in want._fields:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 5, 96])
@pytest.mark.parametrize("grid", [(256, 4, 4), (64, 2, 4), (384, 8, 8)])
def test_make_orders_matches_reference(grid, seed):
    got = FP.make_orders(*grid, seed=seed, device="cpu")
    want = JFP.make_orders(*grid, seed=seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [0, 1, 64, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_gm_round_matches_reference(seed, n):
    truth, view = _state(seed)
    orders = FP.make_orders(W, G, L, seed=seed % 97, device="cpu")
    jorders = JFP.make_orders(W, G, L, seed=seed % 97)
    for g in (0, G - 1):
        for count in (n, torch.tensor(n, dtype=torch.int32)):
            got = FP.gm_round(torch.from_numpy(truth), torch.from_numpy(view), orders[g],
                              count, max_tasks=128)
            want = JFP.gm_round(jnp.asarray(truth), jnp.asarray(view), jorders[g], n,
                                max_tasks=128, use_pallas=False)
            _assert_round_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 64, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_gm_round_conservation(seed, n):
    truth_np, view_np = _state(seed)
    truth, view = torch.from_numpy(truth_np), torch.from_numpy(view_np)
    orders = FP.make_orders(W, G, L, seed=seed % 97, device="cpu")
    res = FP.gm_round(truth, view, orders[0], n, max_tasks=128)
    placed = int((res.workers >= 0).sum())
    assert int(truth.sum()) - int(res.truth.sum()) == placed
    ws = res.workers.numpy()
    ws = ws[ws >= 0]
    assert len(set(ws.tolist())) == len(ws)
    if int(res.n_inconsistent) > 0:
        assert torch.equal(res.view, res.truth)
    # the inputs are left as they were
    assert np.array_equal(truth.numpy(), truth_np) and np.array_equal(view.numpy(), view_np)


@pytest.mark.parametrize("seed", SEEDS)
def test_complete_matches_reference(seed):
    truth, view = _state(seed)
    rng = np.random.default_rng(seed + 7)
    workers = rng.integers(-1, W, 64).astype(np.int32)
    borrowed = rng.random(64) < 0.3
    got = FP.complete(torch.from_numpy(truth), torch.from_numpy(view),
                      torch.from_numpy(workers), torch.from_numpy(borrowed))
    want = JFP.complete(jnp.asarray(truth), jnp.asarray(view),
                        jnp.asarray(workers), jnp.asarray(borrowed))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_matches_reference(seed):
    truth, view = _state(seed)
    lm = (np.arange(W) // (W // L)) == seed % L
    got = FP.heartbeat(torch.from_numpy(view), torch.from_numpy(truth), torch.from_numpy(lm))
    want = JFP.heartbeat(jnp.asarray(view), jnp.asarray(truth), jnp.asarray(lm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gm_round_worker_zero_quirk_matches_reference():
    """Placing worker 0 with fewer tasks than ``max_tasks``: the trailing -1
    entries clip to 0 and write its old view value back, so the reference
    leaves worker 0 free in the view while 1 and 2 are marked busy.  The
    port mirrors that and does not fix it."""
    ones = np.ones(64, bool)
    order = np.arange(64, dtype=np.int32)
    got = FP.gm_round(torch.from_numpy(ones), torch.from_numpy(ones),
                      torch.from_numpy(order), 3, max_tasks=8)
    want = JFP.gm_round(jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(order), 3,
                        max_tasks=8, use_pallas=False)
    _assert_round_equal(got, want)
    assert got.view[:4].tolist() == [True, False, False, True]
    assert got.workers[:3].tolist() == [0, 1, 2]


def test_complete_worker_zero_quirk_matches_reference():
    """``complete`` frees worker 0 in truth and view only when no -1 entry
    follows it, as the reference's in-order scatters do."""
    zeros = np.zeros(8, bool)
    for workers in ([0, -1], [-1, 0]):
        w = np.asarray(workers, np.int32)
        b = np.zeros(2, bool)
        got = FP.complete(torch.from_numpy(zeros), torch.from_numpy(zeros),
                          torch.from_numpy(w), torch.from_numpy(b))
        want = JFP.complete(jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(w),
                            jnp.asarray(b))
        for a, c in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_make_orders_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FP.make_orders(W, G, L)
