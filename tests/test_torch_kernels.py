"""The port's rank-and-select (``repro_torch.kernels``) against the JAX
reference: the plain versions bitwise against ``repro.kernels.ref`` and the
Pallas kernel in interpret mode, and the wrapper's checks.  The CUDA
kernel itself is held against its plain version on the card in
``tests/test_torch_gpu.py``."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.match import match_ranks_batched as pallas_match_ranks_batched
from repro_torch.kernels import build, match, ref

#: the sweep of tests/test_kernels.py, the narrow design's edge (256, 257)
#: and the edges of the wide design's tile (tile - 1, tile, tile + 1,
#: 2 tile + 1)
_TILE = match.WIDE_TILE_LANES
WIDTHS = [1, 100, 128, 256, 257, 1024, _TILE - 1, _TILE, _TILE + 1, 2 * _TILE + 1,
          8192, 50_000]
DTYPES = {
    "int8": (np.int8, torch.int8),
    "int32": (np.int32, torch.int32),
    "bool": (np.bool_, torch.bool),
}


def _case(w: int, dtype: str):
    """Four rows of one width, one row per n in {0, 1, w/2, w}."""
    rng = np.random.default_rng(w)
    avail = (rng.random((4, w)) < 0.4).astype(DTYPES[dtype][0])
    n = np.array([0, 1, w // 2, w], np.int32)
    return avail, n


def _check_ranks(ranks: np.ndarray, avail: np.ndarray, n: np.ndarray) -> None:
    """Each row hands ranks 0..k-1 once each to its first k free lanes,
    k = min(n, free lanes), and -1 to every other lane."""
    for r, a, k in zip(ranks, avail.astype(bool), n):
        free = np.flatnonzero(a)
        k = min(int(k), free.size)
        np.testing.assert_array_equal(r[free[:k]], np.arange(k))
        assert (np.delete(r, free[:k]) == -1).all()


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_plain_matches_reference(w, dtype):
    avail, n = _case(w, dtype)
    got = ref.match_ranks_batched_ref(torch.from_numpy(avail), torch.from_numpy(n))
    assert got.dtype == torch.int32
    got = got.numpy()
    want = np.asarray(jax_ref.match_ranks_batched_ref(jnp.asarray(avail), jnp.asarray(n)))
    np.testing.assert_array_equal(got, want)
    pallas = pallas_match_ranks_batched(jnp.asarray(avail), jnp.asarray(n), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    _check_ranks(got, avail, n)


@pytest.mark.parametrize("w", WIDTHS)
def test_single_row_plain_matches_reference(w):
    avail, n = _case(w, "int8")
    for k in n:
        got = ref.match_ranks_ref(torch.from_numpy(avail[0]), int(k))
        assert got.dtype == torch.int32
        want = jax_ref.match_ranks_ref(jnp.asarray(avail[0]), int(k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g,w", [(512, 64), (300, 8), (64, 256), (16, 33)])
def test_batched_plain_matches_reference_on_narrow_rows(g, w):
    """The sparrow/eagle head-of-queue pick's shape: many narrow [W, R]
    rows with n = 1, then random n per row."""
    rng = np.random.default_rng(g + w)
    avail = rng.random((g, w)) < 0.3
    for n in (np.ones(g, np.int32), rng.integers(0, w + 8, g).astype(np.int32)):
        got = ref.match_ranks_batched_ref(torch.from_numpy(avail), torch.from_numpy(n))
        want = jax_ref.match_ranks_batched_ref(jnp.asarray(avail), jnp.asarray(n))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _check_ranks(got.numpy(), avail, n)
    head = avail[:16]
    pallas = pallas_match_ranks_batched(jnp.asarray(head), jnp.ones(16, jnp.int32),
                                        block_rows=1, interpret=True)
    got = ref.match_ranks_batched_ref(torch.from_numpy(head), torch.ones(16, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize(
    "w,plan",
    [
        (49_984, ("wide", 25)),  # megha borrow [8, 49984]
        (6248, ("wide", 4)),     # megha internal [8, 6248]
        (50_000, ("wide", 25)),  # oracle [1, 50000]
        (64, ("narrow", 0)),     # sparrow/eagle head-of-queue pick [50000, 64]
        (1, ("narrow", 0)),
        (32, ("narrow", 0)),
        (255, ("narrow", 0)),
        (256, ("narrow", 0)),    # the narrow design's widest row
        (257, ("wide", 1)),
        (2047, ("wide", 1)),
        (2048, ("wide", 1)),
        (2049, ("wide", 2)),
        (4097, ("wide", 3)),
    ],
)
def test_batched_plan_picks_design_by_width(w, plan):
    assert match.WIDE_TILE_LANES == 2048 and match.NARROW_MAX_LANES == 256
    assert match._batched_plan(w) == plan


def test_build_digest_sees_headers(tmp_path, monkeypatch):
    """An edited header, source or flag names another library, so a stale
    build is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["lookback.cuh"]
    base = build.source_digest("match", csrc)
    assert base == build.source_digest("match", build.CSRC_DIR)
    header = csrc / "lookback.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.source_digest("match", csrc)
    assert edited != base
    assert build.source_digest("match_tasks", csrc) != \
        build.source_digest("match_tasks", build.CSRC_DIR)
    (csrc / "match.cu").write_text((csrc / "match.cu").read_text() + "\n")
    assert build.source_digest("match", csrc) != edited
    edited = build.source_digest("match", csrc)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.source_digest("match", csrc) != edited


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    avail, n = _case(1024, "bool")
    before = match.match_ranks_batched.launches
    got = match.match_ranks_batched(torch.from_numpy(avail), torch.from_numpy(n))
    want = ref.match_ranks_batched_ref(torch.from_numpy(avail), torch.from_numpy(n))
    assert torch.equal(got, want)
    assert match.match_ranks_batched.launches == before


@pytest.mark.parametrize(
    "avail,n,err",
    [
        (torch.ones(8, dtype=torch.bool), torch.zeros(1, dtype=torch.int32), ValueError),
        (torch.ones(2, 8, dtype=torch.float32), torch.zeros(2, dtype=torch.int32), TypeError),
        (torch.ones(2, 8, dtype=torch.bool), torch.zeros(2, dtype=torch.int64), ValueError),
        (torch.ones(2, 8, dtype=torch.bool), torch.zeros(3, dtype=torch.int32), ValueError),
        (torch.ones(8, 2, dtype=torch.bool).t(), torch.zeros(2, dtype=torch.int32), ValueError),
        (torch.ones(2, 8, dtype=torch.bool), torch.zeros(4, dtype=torch.int32)[::2], ValueError),
    ],
    ids=["1d", "float", "n-int64", "n-shape", "non-contiguous", "n-non-contiguous"],
)
def test_wrapper_rejects_bad_input(avail, n, err):
    with pytest.raises(err):
        match.match_ranks_batched(avail, n)


def test_ptxas_report_is_parsed():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z6kernelIhEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z6kernelIhEvPKT_\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 30 registers, used 1 barriers, 64 bytes smem, "
        "380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z6kernelIiEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 28 registers, used 1 barriers, 380 bytes cmem[0]\n"
    )
    assert build.parse_ptxas(log) == [
        {"function": "_Z6kernelIhEvPKT_", "registers": 30, "smem_bytes": 64,
         "spill_bytes": 12},
        {"function": "_Z6kernelIiEvPKT_", "registers": 28, "smem_bytes": 0,
         "spill_bytes": 0},
    ]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
