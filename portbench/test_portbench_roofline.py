"""The match roofline arithmetic, from shapes only, against the bounds of the
kernel table in PERF.md, and its reader."""

import pytest
import torch

from portbench import devtrace, traffic
from portbench.cpu_cells import ROOT
from portbench.harness import _load_module

roofline = _load_module(ROOT / "portbench" / "metrics" / "match_roofline.py", "mr")
PEAKS = traffic.load_json(ROOT / "portbench" / "peaks.json")


@pytest.mark.parametrize("rows, width, bound_us", [
    (8, 49984, 0.597),       # megha's borrow rows, bool, every lane read
    (300000, 40, 18.269),    # the n = 1 pick of a B = 6 sparrow grid, every lane
])
def test_bound_matches_the_kernel_table(rows, width, bound_us):
    got = roofline.bound_s(rows, width, 1, rows * width, PEAKS) * 1e6
    assert got == pytest.approx(bound_us, abs=5e-4)


def test_needed_lanes():
    avail = torch.tensor([[1, 0, 1, 1, 0], [0, 0, 0, 1, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]],
                         dtype=torch.bool)
    n = torch.tensor([2, 2, 0, 1], dtype=torch.int32)
    # row 0: the 2nd free lane is lane 2; row 1: fewer free than n; row 2:
    # n = 0 needs nothing; row 3: the 1st free lane is lane 0
    assert devtrace.needed_lanes(avail, n).tolist() == [3, 5, 0, 1]


def test_reader():
    launches = [dict(rows=8, width=49984, elem=1, lanes=8 * 49984)] * 2
    bound = roofline.bound_s(8, 49984, 1, 8 * 49984, PEAKS)
    ctx = dict(peaks=PEAKS, match_launches=launches,
               device=[("void match_batched_wide_kernel<bool>", 0.0, 2 * bound),
                       ("other", 0.0, 1.0),
                       ("void match_batched_wide_kernel<bool>", 1.0, 1.0 + 2 * bound)])
    assert roofline.read(ctx) == pytest.approx(50.0)
    # a launch count that does not pair with the trace reads nothing
    assert roofline.read(dict(ctx, match_launches=launches[:1])) is None
    assert roofline.read(dict(ctx, device=[])) is None
