"""The control comes out not correct: the plain reference computed with its
times in bfloat16 (the precision next below the configuration's float32),
put in the program's place and compared as the program is, on three seeds,
for every rule of the manifest.  On the card ``portbench/calibrate.py``
reads it at the cells' own size."""

import pytest
import torch

from portbench import judge
from portbench.calibrate import control_numbers
from portbench.cpu_cells import CELLS, one_thread, tiny
from portbench.harness import Run


@pytest.mark.parametrize("rule", list(CELLS))
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 424242])
def test_control_fails(rule, seed):
    cell = tiny(rule)
    run = Run(cell, seed, 0.0, False, "cpu", {"start": 0.0})
    with one_thread():
        run.setup()
        values = control_numbers(run, torch.bfloat16)
    ok, lines = judge.verdict(values, cell.checks["limits"])
    assert not ok, lines
    assert values["finish_gap_s"] > 0.0
