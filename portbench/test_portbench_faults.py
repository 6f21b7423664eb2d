"""The comparison catches a broken timed path: the harness's run on the CPU
(its look for a card skipped), with a fault planted underneath the program,
comes out not correct.  One cell's faults: a step that returns its state
unchanged, half the batch of points left out, and an answer altered where it
is produced.  The cells run on one card: no exchange between cards exists to
leave out."""

import dataclasses

import pytest
import torch

from portbench.cpu_cells import run_tiny, tiny
from repro_torch.simx import runtime


def _unchanged(monkeypatch):
    # every round hands its state back as it found it
    monkeypatch.setattr(runtime, "scan_rounds", lambda step, state, n: state)


def _half_batch(monkeypatch):
    # the rounds advance only the first half of the points; the rest keep
    # their fresh state
    scan = runtime.scan_rounds

    def half(step, state, n):
        out = scan(step, state, n)
        keep = state.t.shape[0] // 2
        return dataclasses.replace(out, **{
            f.name: torch.cat([getattr(out, f.name)[:keep], getattr(state, f.name)[keep:]])
            for f in dataclasses.fields(out)})

    monkeypatch.setattr(runtime, "scan_rounds", half)


def _altered(monkeypatch):
    # one task's finish time recorded a round late where it is launched
    launch = runtime.apply_launch

    def late(launch_w, task_pick, start, dur_pad, task_finish, *rest):
        tf, wf, wt = launch(launch_w, task_pick, start, dur_pad, task_finish, *rest)
        hit = tf[..., 7:8]
        return (torch.cat([tf[..., :7], torch.where(torch.isinf(hit), hit, hit + 0.05),
                           tf[..., 8:]], -1), wf, wt)

    monkeypatch.setattr(runtime, "apply_launch", late)


@pytest.mark.parametrize("rule", ["megha", "sparrow"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_a_planted_fault_is_not_correct(rule, fault, monkeypatch):
    fault(monkeypatch)
    run = run_tiny(tiny(rule))
    assert not run.correct, run.check_lines
    assert run.failed > 0
    assert run.result()["correct"] is False
