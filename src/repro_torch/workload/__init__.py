"""Workload model and generators (copies of ``repro.workload``'s
pure-Python parts, so the port imports nothing of the reference)."""

from repro_torch.workload.synth import (
    ArrivalProcess,
    DiurnalArrivals,
    MMPPArrivals,
    PhasedArrivals,
    PoissonArrivals,
    ReplayArrivals,
    bimodal_job_factory,
    downsampled,
    fixed_job_factory,
    google_like_trace,
    synthetic_trace,
    yahoo_like_trace,
)
from repro_torch.workload.traces import Job, Task, Workload, load_workload, save_workload

__all__ = [
    "ArrivalProcess",
    "DiurnalArrivals",
    "Job",
    "MMPPArrivals",
    "PhasedArrivals",
    "PoissonArrivals",
    "ReplayArrivals",
    "Task",
    "Workload",
    "bimodal_job_factory",
    "downsampled",
    "fixed_job_factory",
    "google_like_trace",
    "load_workload",
    "save_workload",
    "synthetic_trace",
    "yahoo_like_trace",
]
