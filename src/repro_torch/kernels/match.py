"""Rank-and-select for the GM match: the hand-written Hopper kernel.

Port of the TPU kernel ``match_ranks_batched`` (``repro/kernels/match.py``,
body ``_match_kernel_batched``).  The CUDA source is ``csrc/match.cu``; it
is compiled by ``build.py`` at the first launch and called through
``ctypes``.  A tensor on the CPU goes to the plain version in ``ref.py``; a
tensor on a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build, ref

#: avail dtype -> the kernel's dtype code (bool is read as uint8)
_DTYPE_CODES = {torch.bool: 0, torch.int8: 1, torch.int32: 2}


@lru_cache(maxsize=None)
def _launch_fn():
    """The C entry point, with every pointer and the stream as
    ``c_void_p`` (the ctypes default would pass them as 32-bit ints)."""
    fn = build.load("match").match_ranks_batched_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def match_ranks_batched(avail: torch.Tensor, n_tasks: torch.Tensor) -> torch.Tensor:
    """Per-row task ranks: ``avail`` bool/int8/int32[G, W] (each row in one
    GM's priority order, values 0/1), ``n_tasks`` int32[G] -> int32[G, W],
    the rank of each selected lane and -1 elsewhere (see ``ref.py``).

    Both tensors must be contiguous and on one device.  ``launches`` counts
    the kernel launches (CPU calls and empty inputs launch nothing)."""
    if avail.dim() != 2:
        raise ValueError(f"avail must be 2-D [G, W], got shape {tuple(avail.shape)}")
    if avail.dtype not in _DTYPE_CODES:
        raise TypeError(f"avail must be bool, int8 or int32, got {avail.dtype}")
    g, w = avail.shape
    if n_tasks.dtype != torch.int32 or tuple(n_tasks.shape) != (g,):
        raise ValueError(
            f"n_tasks must be int32[{g}], got {n_tasks.dtype}{list(n_tasks.shape)}"
        )
    if n_tasks.device != avail.device:
        raise ValueError(
            f"avail on {avail.device} but n_tasks on {n_tasks.device}"
        )
    if not (avail.is_contiguous() and n_tasks.is_contiguous()):
        raise ValueError("avail and n_tasks must be contiguous")
    if avail.device.type == "cpu":
        return ref.match_ranks_batched_ref(avail, n_tasks)
    if avail.device.type != "cuda":
        raise ValueError(f"no kernel for device {avail.device}")
    out = torch.empty((g, w), dtype=torch.int32, device=avail.device)
    if out.numel() == 0:
        return out
    launch = _launch_fn()
    with torch.cuda.device(avail.device):
        stream = torch.cuda.current_stream(avail.device).cuda_stream
        err = launch(
            avail.data_ptr(), _DTYPE_CODES[avail.dtype], n_tasks.data_ptr(),
            out.data_ptr(), g, w, stream,
        )
    if err != 0:
        raise RuntimeError(f"match_ranks_batched kernel launch failed: CUDA error {err}")
    match_ranks_batched.launches += 1
    return out


match_ranks_batched.launches = 0
