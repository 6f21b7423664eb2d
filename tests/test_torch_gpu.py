"""The port on a CUDA card: the hand-written kernel against its plain
version, and a small megha / oracle run on the card against the same run
on the CPU.  Every test here carries the ``gpu`` marker and skips itself
without a card.  This file imports no ``jax`` (the card's machine has
none); run it there with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import match, ref
from repro_torch.simx import convert, simulate_workload
from repro_torch.workload.synth import synthetic_trace

WIDTHS = [1, 100, 128, 1024, 8192, 50_000]
DTYPES = [torch.int8, torch.int32, torch.bool]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_kernel_matches_plain_version(w, dtype):
    _need_card()
    gen = torch.Generator().manual_seed(w)
    avail = (torch.rand((4, w), generator=gen) < 0.4).to(dtype).cuda()
    for n in ([0, 1, w // 2, w], torch.randint(0, w + 1, (4,), generator=gen).tolist()):
        nt = torch.tensor(n, dtype=torch.int32, device="cuda")
        before = match.match_ranks_batched.launches
        got = match.match_ranks_batched(avail, nt)
        torch.cuda.synchronize()
        assert match.match_ranks_batched.launches == before + 1
        assert torch.equal(got, ref.match_ranks_batched_ref(avail, nt))


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
