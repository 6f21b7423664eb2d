"""What the benchmark's CPU tests share: the cells of ``BENCHMARK.json`` cut
to a size a CPU test holds (640 workers, 2 loads x 2 scheduler seeds, 12
jobs of 96 one-second tasks), run through the harness on the CPU.

The rules the tests run are the manifest's: ``CELLS`` maps each
configuration's ``scheduler`` to the first cell that runs it, in the
manifest's order, so a rule that joins with its files and entries is
compared with its reference, its control and its planted faults with no
test edited."""

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402


def first_cells(root: Path) -> dict:
    """Each scheduler of ``root/BENCHMARK.json``: the first cell that runs
    it, in the manifest's order."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    scheduler = {c["name"]: json.loads((root / c["file"]).read_text())["scheduler"]
                 for c in manifest["configs"]}
    cells: dict = {}
    for w in manifest["workloads"]:
        cells.setdefault(scheduler[w["config"]], w["name"])
    return cells


CELLS = first_cells(ROOT)
TINY = dict(loads=[0.6, 0.95], scheduler_seeds=2, num_jobs=12, tasks_per_job=96)


def shrink(cell: harness.Cell, **cfg) -> harness.Cell:
    """``cell`` cut to the tiny size in place (``cfg`` overrides
    configuration keys)."""
    cell.cfg.update(num_workers=640, **cfg)
    cell.traffic.update(TINY)
    cell.checks["points"] = 2
    return cell


def tiny(rule: str, **cfg) -> harness.Cell:
    """The rule's cell of the manifest at the tiny size (``cfg`` overrides
    configuration keys)."""
    return shrink(harness.resolve(ROOT, CELLS[rule]), **cfg)


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the block: the test runner's workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 5, trace: bool = False) -> harness.Run:
    """A whole run of ``cell`` on the CPU, short of the check of loaded
    modules (the test process has loaded JAX for other tests)."""
    t = time.perf_counter()
    run = harness.Run(cell, seed, 0.0, trace, "cpu", {"start": t, "imports": t, "cuda_init": t})
    with one_thread():
        run.setup()
        run.window()
        run.compare()
    return run
