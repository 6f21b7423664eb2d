"""The port on a CUDA card: the hand-written kernels against their plain
versions, and small megha / oracle / serving-engine runs on the card
against the same runs on the CPU.  Every test here carries the ``gpu`` marker and skips itself
without a card.  This file imports no ``jax`` (the card's machine has
none); run it there with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import match, ref
from repro_torch.serve.engine import MeghaServeEngine, Request
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
