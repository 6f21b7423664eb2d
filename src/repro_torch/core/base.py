"""Shared scheduler constants of the reference, copied so the port imports
nothing of ``repro``."""

from __future__ import annotations

#: Default threshold (seconds of estimated runtime) separating short and long
#: jobs for estimate-based schedulers and for reporting (Fig. 3c/3d).
#: Copied from ``repro/core/base.py`` (``LONG_JOB_THRESHOLD``).
LONG_JOB_THRESHOLD = 10.0


def grid_workers(num_workers: int, num_gms: int, num_lms: int) -> int:
    """Shave the worker count so the GM x LM partition grid divides evenly
    — the one rule shared by every Megha construction site.  Copied from
    ``repro/core/megha.py`` (``grid_workers``)."""
    per = num_workers // (num_gms * num_lms)
    return per * num_gms * num_lms
