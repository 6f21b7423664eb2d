"""The comparison catches a broken timed path: the harness's run on the CPU
(its look for a card skipped), with a fault planted underneath the program,
comes out not correct.  One cell's faults, for every rule of the manifest: a
step that returns its state unchanged, half the batch of points left out,
and an answer altered where it is produced.  The cells run on one card: no
exchange between cards exists to leave out."""

import dataclasses

import pytest
import torch

from portbench.cpu_cells import CELLS, run_tiny, tiny
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


def _late(task_finish):
    # task 7's finish a round (0.05 s) later, where it is finite
    hit = task_finish[..., 7:8]
    return torch.cat([task_finish[..., :7], torch.where(torch.isinf(hit), hit, hit + 0.05),
                      task_finish[..., 8:]], -1)


def _altered(monkeypatch):
    # one task's finish time recorded a round late where it is launched: in
    # ``runtime.apply_launch`` for a rule whose step records its launches
    # there, else in the state the rounds hand back
    launch, scan = runtime.apply_launch, runtime.scan_rounds
    called = []

    def late(launch_w, task_pick, start, dur_pad, task_finish, *rest):
        called.append(True)
        tf, wf, wt = launch(launch_w, task_pick, start, dur_pad, task_finish, *rest)
        return _late(tf), wf, wt

    def scan_late(step, state, n):
        called.clear()
        out = scan(step, state, n)
        if called:
            return out
        return dataclasses.replace(out, task_finish=_late(out.task_finish))

    monkeypatch.setattr(runtime, "apply_launch", late)
    monkeypatch.setattr(runtime, "scan_rounds", scan_late)


@pytest.mark.parametrize("rule", list(CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_a_planted_fault_is_not_correct(rule, fault, monkeypatch):
    fault(monkeypatch)
    run = run_tiny(tiny(rule))
    assert not run.correct, run.check_lines
    assert run.failed > 0
    assert run.result()["correct"] is False
