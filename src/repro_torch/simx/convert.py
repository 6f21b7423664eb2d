"""Carry the reference's round state and trace across as numpy dicts.

The reference has no weights: its "parameters" are the exported trace,
the GM orders and the round state.  These helpers turn dicts of numpy
arrays (built from the reference's dataclasses with ``np.asarray`` on each
field) into the port's tensors and back, without importing ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.simx.state import TaskArrays


def _tensor(value, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def tasks_from_numpy(arrays: dict, device=None) -> TaskArrays:
    """``TaskArrays`` from a dict of numpy arrays keyed by field name."""
    dev = resolve_device(device)
    return TaskArrays(**{
        f.name: _tensor(arrays[f.name], dev) for f in dataclasses.fields(TaskArrays)
    })


def state_from_numpy(cls, arrays: dict, device=None):
    """A state of dataclass ``cls`` from a dict of numpy arrays keyed by
    field name (dtypes are kept: int32 stays int32, bool stays bool)."""
    dev = resolve_device(device)
    return cls(**{f.name: _tensor(arrays[f.name], dev) for f in dataclasses.fields(cls)})


def state_to_numpy(state) -> dict:
    """The fields of a state (or ``TaskArrays``) as numpy arrays on the host."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }
