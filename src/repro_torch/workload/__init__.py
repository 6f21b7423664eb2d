"""Workload model and generators (copies of ``repro.workload``'s
pure-Python parts, so the port imports nothing of the reference)."""

from repro_torch.workload.synth import (
    downsampled,
    google_like_trace,
    synthetic_trace,
    yahoo_like_trace,
)
from repro_torch.workload.traces import Job, Task, Workload

__all__ = [
    "Job",
    "Task",
    "Workload",
    "downsampled",
    "google_like_trace",
    "synthetic_trace",
    "yahoo_like_trace",
]
