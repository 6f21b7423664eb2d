"""Rank-and-select for the GM match: the hand-written Hopper kernels.

Ports of the two TPU kernels of ``repro/kernels/match.py``:

* ``match_ranks_batched`` (body ``_match_kernel_batched``), CUDA source
  ``csrc/match.cu``: one block per row of ``[G, W]``;
* ``match_ranks`` (body ``_match_kernel``), CUDA source
  ``csrc/match_tasks.cu``: one row split over many blocks by a decoupled
  look-back scan, with a second entry point ``match_tasks`` that fuses the
  inverse scatter of ``ops.match_tasks`` into the same launch.

Each source is compiled by ``build.py`` at its first launch and called
through ``ctypes``.  A tensor on the CPU goes to the plain version in
``ref.py``; a tensor on a CUDA device launches the kernel or raises.
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


@lru_cache(maxsize=None)
def _single_fns():
    """The single-row library's entry points: (launch, lanes per tile)."""
    lib = build.load("match_tasks")
    fn = lib.match_single_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.match_single_tile_lanes.argtypes = []
    lib.match_single_tile_lanes.restype = ctypes.c_int
    return fn, lib.match_single_tile_lanes()


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


#: the kernel's epochs take 30 bits of a status word; 0 is never used, so
#: zeroed words read as "not yet published"
_MAX_EPOCH = (1 << 30) - 1
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class _LookbackScratch:
    """The look-back status words of the single-row kernel on one stream:
    one 64-bit word per tile, zeroed when allocated and when the epoch
    wraps, otherwise reused as they are (each launch tags its words with a
    new epoch, and the kernel reads words of another epoch as unwritten).
    Launches on one stream run one after another, so they never share an
    epoch's words."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.words = torch.zeros(0, dtype=torch.int64, device=device)
        self.epoch = 0

    def take(self, tiles: int) -> tuple[torch.Tensor, int]:
        if self.words.numel() < tiles:
            self.words = torch.zeros(max(tiles, 64), dtype=torch.int64, device=self.device)
            self.epoch = 0
        self.epoch += 1
        if self.epoch > _MAX_EPOCH:
            self.words.zero_()
            self.epoch = 1
        return self.words, self.epoch


#: (device index, stream handle) -> its scratch; device memory held for the
#: life of the process, like the loaded libraries
_SCRATCH: dict[tuple[int, int], _LookbackScratch] = {}


def clamp_n(n: torch.Tensor | int, max_tasks: int) -> torch.Tensor | int:
    """``min(n, max_tasks)``, as ``ops.match_tasks`` clamps its count; a
    tensor stays on its device (no host read)."""
    if isinstance(n, torch.Tensor):
        return torch.clamp(n.reshape(()), max=max_tasks)
    return min(n, max_tasks)


def _check_row(avail: torch.Tensor, n) -> None:
    if avail.dim() != 1:
        raise ValueError(f"avail must be 1-D [W], got shape {tuple(avail.shape)}")
    if avail.dtype not in _DTYPE_CODES:
        raise TypeError(f"avail must be bool, int8 or int32, got {avail.dtype}")
    if not avail.is_contiguous():
        raise ValueError("avail must be contiguous")
    if avail.shape[0] >= 1 << 30:
        raise ValueError("avail has more lanes than the kernel's status words count")
    if isinstance(n, torch.Tensor):
        if n.dtype != torch.int32 or n.numel() != 1:
            raise ValueError(f"n must be a Python int or one int32, got {n.dtype}{list(n.shape)}")
        if n.device != avail.device:
            raise ValueError(f"avail on {avail.device} but n on {n.device}")
    elif not isinstance(n, int):
        raise TypeError(f"n must be a Python int or an int32 tensor, got {type(n).__name__}")


def _launch_single(avail: torch.Tensor, n, max_tasks: int, fused: bool,
                   out: torch.Tensor, placed: torch.Tensor | None) -> None:
    """One launch of ``csrc/match_tasks.cu`` on the current stream."""
    launch, tile_lanes = _single_fns()
    w = avail.shape[0]
    if isinstance(n, torch.Tensor):
        n_ptr, n_val = n.data_ptr(), 0
    else:
        n_ptr, n_val = None, min(max(n, _INT32_MIN), _INT32_MAX)
    with torch.cuda.device(avail.device):
        stream = torch.cuda.current_stream(avail.device).cuda_stream
        key = (avail.device.index, stream)
        scratch = _SCRATCH.get(key)
        if scratch is None:
            scratch = _SCRATCH[key] = _LookbackScratch(avail.device)
        words, epoch = scratch.take(-(-w // tile_lanes))
        err = launch(
            avail.data_ptr(), _DTYPE_CODES[avail.dtype], w, n_ptr, n_val,
            max_tasks, int(fused), out.data_ptr(),
            None if placed is None else placed.data_ptr(),
            words.data_ptr(), epoch, stream,
        )
    if err != 0:
        raise RuntimeError(f"match_tasks.cu kernel launch failed: CUDA error {err}")


def match_ranks(avail: torch.Tensor, n: torch.Tensor | int) -> torch.Tensor:
    """Task ranks over one row: ``avail`` bool/int8/int32[W] (one GM's
    priority order, values 0/1), ``n`` a Python int or one int32 on the
    same device -> int32[W], the rank of each selected lane and -1
    elsewhere (see ``ref.match_ranks_ref``).

    ``launches`` counts the kernel launches (CPU calls and empty rows
    launch nothing)."""
    _check_row(avail, n)
    if avail.device.type == "cpu":
        return ref.match_ranks_ref(avail, n)
    if avail.device.type != "cuda":
        raise ValueError(f"no kernel for device {avail.device}")
    out = torch.empty(avail.shape, dtype=torch.int32, device=avail.device)
    if out.numel() == 0:
        return out
    _launch_single(avail, n, 0, False, out, None)
    match_ranks.launches += 1
    return out


match_ranks.launches = 0


def match_tasks(
    avail: torch.Tensor, n: torch.Tensor | int, max_tasks: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match up to ``min(n, max_tasks)`` tasks onto the free lanes of one
    row in priority order, in one launch: ``assignment`` int32[max_tasks]
    (the lane of each task, -1 where unplaced) and ``placed`` int32[] (see
    ``ops.match_tasks``).  ``avail`` and ``n`` as for ``match_ranks``.

    ``launches`` counts the kernel launches (CPU calls and empty rows
    launch nothing)."""
    _check_row(avail, n)
    if max_tasks < 0:
        raise ValueError(f"max_tasks must be >= 0, got {max_tasks}")
    if avail.device.type == "cpu":
        return ref.match_tasks_ref(avail, clamp_n(n, max_tasks), max_tasks)
    if avail.device.type != "cuda":
        raise ValueError(f"no kernel for device {avail.device}")
    if avail.shape[0] == 0:
        return (torch.full((max_tasks,), -1, dtype=torch.int32, device=avail.device),
                torch.zeros((), dtype=torch.int32, device=avail.device))
    out = torch.empty((max_tasks,), dtype=torch.int32, device=avail.device)
    placed = torch.empty((), dtype=torch.int32, device=avail.device)
    _launch_single(avail, n, max_tasks, True, out, placed)
    match_tasks.launches += 1
    return out, placed


match_tasks.launches = 0
