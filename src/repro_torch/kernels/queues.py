"""Passes over the sparrow and eagle rules' reservation queues: the
hand-written Hopper kernels.

The queues are ``resq int32[*P, W, R]`` (P the point axes, which may be
none; entries in ``[0, J]``, J meaning empty).  Three entry points, each one
launch of ``csrc/queues.cu`` where eager PyTorch made a chain of passes:

* ``queue_compact(resq, unfinished)``: recycle the entries of finished jobs
  and slide the live ones to the front of each queue, in order;
* ``queue_scan(resq, pending, row_mask, dead)``: the active mask that the
  n = 1 pick ranks, and the jobs holding a reservation (orphan rescue);
* ``queue_head(resq, ranks, num_jobs)``: each queue's entry at the pick.

No TPU kernel stands behind them: the JAX package leaves these element-wise
chains to XLA, which fuses them.  The source is compiled by ``build.py`` at
its first launch and called through ``ctypes``.  A tensor on the CPU goes to
the plain version in ``ref.py``; a tensor on a CUDA device launches the
kernel or raises.  Each entry point counts its launches in ``launches``.
None reads a device value on the host.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build, ref

#: the widest queue row the kernels take: 32 lanes x 8 slots, the narrow
#: match design's limit (``match.NARROW_MAX_LANES``)
MAX_LANES = 256


@lru_cache(maxsize=None)
def _fns():
    """The entry points of ``csrc/queues.cu``: (compact, scan, head), with
    every pointer and the stream as ``c_void_p``."""
    lib = build.load("queues")
    lib.queue_max_lanes.argtypes = []
    lib.queue_max_lanes.restype = ctypes.c_int
    if lib.queue_max_lanes() != MAX_LANES:
        raise RuntimeError(
            f"csrc/queues.cu takes rows of {lib.queue_max_lanes()} slots, "
            f"MAX_LANES says {MAX_LANES}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    compact, scan, head = lib.queue_compact_launch, lib.queue_scan_launch, lib.queue_head_launch
    compact.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    scan.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    head.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    compact.restype = scan.restype = head.restype = ctypes.c_int
    return compact, scan, head


def _check_queues(resq: torch.Tensor) -> None:
    if resq.dim() < 2:
        raise ValueError(f"resq must be [*P, W, R], got shape {tuple(resq.shape)}")
    if resq.dtype != torch.int32:
        raise TypeError(f"resq must be int32, got {resq.dtype}")
    if not resq.is_contiguous():
        raise ValueError("resq must be contiguous")


def _check_table(resq: torch.Tensor, table: torch.Tensor, name: str) -> None:
    if table.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {table.dtype}")
    if table.dim() < 1 or table.shape[:-1] != resq.shape[:-2] or table.shape[-1] < 1:
        raise ValueError(
            f"{name} must be [*P, J + 1] over resq's points {list(resq.shape[:-2])}, "
            f"got {list(table.shape)}")
    if table.device != resq.device:
        raise ValueError(f"resq on {resq.device} but {name} on {table.device}")
    if not table.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _row_flags(resq: torch.Tensor, flags: torch.Tensor | None, name: str):
    """``flags`` (bool, one per queue row) laid out as ``[*P, W]``."""
    if flags is None:
        return None
    if flags.dtype != torch.bool:
        raise TypeError(f"{name} must be bool, got {flags.dtype}")
    if flags.device != resq.device:
        raise ValueError(f"resq on {resq.device} but {name} on {flags.device}")
    return flags.expand(resq.shape[:-1]).contiguous()


def _dims(resq: torch.Tensor) -> tuple[int, int, int]:
    """``(P, W, R)`` of a non-empty ``resq`` for a launch; raises on a row
    the kernels do not take."""
    W, R = resq.shape[-2:]
    if R > MAX_LANES:
        raise ValueError(f"queues of {R} slots: the kernels take at most {MAX_LANES}")
    return resq.numel() // (W * R), W, R


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def queue_compact(
    resq: torch.Tensor, unfinished: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Recycle the dead entries of ``resq`` and re-compact each queue: an
    entry lives while its job ``< J`` has ``unfinished[*P, job] > 0``
    (``unfinished int32[*P, J + 1]``, the last slot the pad).  Returns
    ``(buf, fill)``: ``buf int32[resq.numel() + 1]`` holds the compacted
    queues in ``resq``'s layout (``buf[:-1].view(resq.shape)``), live
    entries first in their order and J after them, then one pad slot
    (J) that a scatter may write and no reader reads; ``fill int32[*P,
    W]`` counts each queue's live entries.

    ``buf`` is new on every call and shares no memory with ``resq``, so
    the caller may write into it in place (``sparrow.insert_probes``)."""
    _check_queues(resq)
    _check_table(resq, unfinished, "unfinished")
    J = unfinished.shape[-1] - 1
    n = resq.numel()
    if resq.device.type == "cpu":
        out, fill = ref.queue_compact_ref(resq, unfinished)
        buf = torch.empty(n + 1, dtype=torch.int32)
        buf[:n].view(resq.shape).copy_(out)
        buf[n] = J
        return buf, fill
    if resq.device.type != "cuda":
        raise ValueError(f"no kernel for device {resq.device}")
    buf = torch.empty(n + 1, dtype=torch.int32, device=resq.device)
    fill = torch.empty(resq.shape[:-1], dtype=torch.int32, device=resq.device)
    if n == 0:
        buf.fill_(J)
        return buf, fill
    P, W, R = _dims(resq)
    compact, _, _ = _fns()
    pad = buf[n:]
    with torch.cuda.device(resq.device):
        err = compact(resq.data_ptr(), unfinished.data_ptr(), buf.data_ptr(), fill.data_ptr(),
                      pad.data_ptr(), P, W, R, J, _stream(resq.device))
    _raise_on(err, "queue_compact")
    queue_compact.launches += 1
    return buf, fill


queue_compact.launches = 0


def queue_scan(
    resq: torch.Tensor,
    pending: torch.Tensor,
    row_mask: torch.Tensor | None = None,
    dead: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass over the queues for the pick and the orphan rescue.
    Returns ``(active bool[*P, W, R], has_res bool[*P, J])``: an entry is
    active where its job ``< J`` has ``pending[*P, job] > 0`` (``pending
    int32[*P, J + 1]``) and, where given, its row's ``row_mask`` (bool,
    one per queue row); ``has_res`` marks the jobs holding an entry on a
    worker that is not ``dead`` (bool, one per queue row, where given)."""
    _check_queues(resq)
    _check_table(resq, pending, "pending")
    row_mask = _row_flags(resq, row_mask, "row_mask")
    dead = _row_flags(resq, dead, "dead")
    if resq.device.type == "cpu":
        return ref.queue_scan_ref(resq, pending, row_mask, dead)
    if resq.device.type != "cuda":
        raise ValueError(f"no kernel for device {resq.device}")
    J = pending.shape[-1] - 1
    active = torch.empty(resq.shape, dtype=torch.bool, device=resq.device)
    has_res = torch.zeros(resq.shape[:-2] + (J,), dtype=torch.bool, device=resq.device)
    if resq.numel() == 0:
        return active, has_res
    P, W, R = _dims(resq)
    _, scan, _ = _fns()
    with torch.cuda.device(resq.device):
        err = scan(resq.data_ptr(), pending.data_ptr(), _ptr(row_mask), _ptr(dead),
                   active.data_ptr(), has_res.data_ptr(), P, W, R, J, _stream(resq.device))
    _raise_on(err, "queue_scan")
    queue_scan.launches += 1
    return active, has_res


queue_scan.launches = 0


def queue_head(resq: torch.Tensor, ranks: torch.Tensor, num_jobs: int) -> torch.Tensor:
    """int32[*P, W] — each queue's entry at the first slot whose rank is 0
    (``ranks`` int32, the n = 1 pick over the queue rows, in any shape of
    ``resq``'s size, contiguous), ``num_jobs`` (J) where a row has none."""
    _check_queues(resq)
    if ranks.dtype != torch.int32 or ranks.numel() != resq.numel():
        raise ValueError(
            f"ranks must be int32 of {resq.numel()} entries, "
            f"got {ranks.dtype}{list(ranks.shape)}")
    if ranks.device != resq.device:
        raise ValueError(f"resq on {resq.device} but ranks on {ranks.device}")
    if not ranks.is_contiguous():
        raise ValueError("ranks must be contiguous")
    if resq.device.type == "cpu":
        return ref.queue_head_ref(resq, ranks, num_jobs)
    if resq.device.type != "cuda":
        raise ValueError(f"no kernel for device {resq.device}")
    head = torch.empty(resq.shape[:-1], dtype=torch.int32, device=resq.device)
    if resq.numel() == 0:
        return head.fill_(num_jobs)
    P, W, R = _dims(resq)
    _, _, launch = _fns()
    with torch.cuda.device(resq.device):
        err = launch(resq.data_ptr(), ranks.data_ptr(), head.data_ptr(), P, W, R, num_jobs,
                     _stream(resq.device))
    _raise_on(err, "queue_head")
    queue_head.launches += 1
    return head


queue_head.launches = 0
