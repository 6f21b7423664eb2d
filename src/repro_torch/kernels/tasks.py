"""One pass over the task axis of the sparrow and eagle rules: the
hand-written Hopper kernel.

``task_scan(task_finish, submit, job, t, num_jobs)`` gives, per point, the
two per-job counts a round needs and late binding's list of pending tasks:

* ``unfinished int32[*P, J + 1]``: each job's tasks with ``task_finish >
  t`` (launched but running included), the last slot the pad job;
* ``pending int32[*P, J + 1]``: each job's tasks not yet launched
  (``task_finish`` infinite) whose ``submit <= t``;
* ``plist int32[*P, T]``: each point's pending tasks in ascending order.
  Entries past the point's pending total are never read; the kernel leaves
  them unwritten.

With ``submit=None`` only ``unfinished`` is computed (``pending`` and
``plist`` come back as None).  ``job`` values lie in ``[0, J]``; ``job`` and
``submit`` are one row shared by every point or one row per point
(lane-stacked windows).

No TPU kernel stands behind it: the JAX package leaves these chains to XLA,
which fuses them.  The source (``csrc/tasks.cu``) is compiled by
``build.py`` at its first launch and called through ``ctypes``.  A tensor
on the CPU goes to the plain version in ``ref.py``; a tensor on a CUDA
device launches the kernel or raises.  The wrapper counts its launches in
``task_scan.launches`` and reads no device value on the host.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build, match, ref

#: tasks per block: ``kTile`` of ``csrc/tasks.cu``, checked at load
TILE_TASKS = 4096


@lru_cache(maxsize=None)
def _launch_fn():
    """``task_scan_launch`` of ``csrc/tasks.cu``, every pointer and the
    stream as ``c_void_p``."""
    lib = build.load("tasks")
    lib.task_scan_tile.argtypes = []
    lib.task_scan_tile.restype = ctypes.c_int
    if lib.task_scan_tile() != TILE_TASKS:
        raise RuntimeError(
            f"csrc/tasks.cu tiles rows by {lib.task_scan_tile()} tasks, "
            f"TILE_TASKS says {TILE_TASKS}")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.task_scan_launch
    fn.argtypes = [ptr, ptr, i64, ptr, i64, ptr, i32, i32, i32, ptr, ptr, ptr, ctypes.c_uint,
                   ptr]
    fn.restype = ctypes.c_int
    return fn


def _row_stride(x: torch.Tensor, name: str, rows: int, n_tasks: int, dtype, device) -> int:
    """0 for one row shared by every point, ``n_tasks`` for one row per
    point; raises on anything else."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"task_finish on {device} but {name} on {x.device}")
    if x.shape[-1] != n_tasks or x.numel() not in (n_tasks, rows * n_tasks):
        raise ValueError(
            f"{name} must be [T] or one row of T = {n_tasks} per point ({rows}), "
            f"got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return 0 if x.numel() == n_tasks else n_tasks


def task_scan(
    task_finish: torch.Tensor,
    submit: torch.Tensor | None,
    job: torch.Tensor,
    t: torch.Tensor,
    num_jobs: int,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """``(unfinished, pending, plist)`` of ``task_finish float32[*P, T]``
    at ``t float32[*P]`` (see the module's docstring); ``(unfinished, None,
    None)`` when ``submit`` is None."""
    if task_finish.dtype != torch.float32:
        raise TypeError(f"task_finish must be float32, got {task_finish.dtype}")
    if task_finish.dim() < 1:
        raise ValueError("task_finish must be [*P, T]")
    lead, T = task_finish.shape[:-1], task_finish.shape[-1]
    if tuple(t.shape) not in (tuple(lead), ()) or t.dtype != torch.float32:
        raise ValueError(
            f"t must be float32 {list(lead)} (or a scalar), got {t.dtype}{list(t.shape)}")
    dev = task_finish.device
    if dev.type == "cpu":
        return ref.task_scan_ref(task_finish, submit, job, t, num_jobs)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    rows = lead.numel()
    job_stride = _row_stride(job, "job", rows, T, torch.int32, dev)
    sub_stride = 0 if submit is None else _row_stride(submit, "submit", rows, T,
                                                      torch.float32, dev)
    if t.device != dev:
        raise ValueError(f"task_finish on {dev} but t on {t.device}")
    J = num_jobs
    n_tables = 1 if submit is None else 2
    counts = torch.empty((n_tables,) + tuple(lead) + (J + 1,), dtype=torch.int32, device=dev)
    plist = None if submit is None else torch.empty(task_finish.shape, dtype=torch.int32,
                                                    device=dev)
    if rows == 0 or T == 0:
        counts.zero_()
    else:
        fin = task_finish.contiguous()
        tt = t.reshape(-1).expand(rows).contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            words, epoch = None, 0
            if submit is not None:
                words, epoch = match._scratch(dev, stream).take(rows * -(-T // TILE_TASKS))
            err = _launch_fn()(
                fin.data_ptr(), None if submit is None else submit.data_ptr(), sub_stride,
                job.data_ptr(), job_stride, tt.data_ptr(), rows, T, J, counts.data_ptr(),
                None if plist is None else plist.data_ptr(),
                None if words is None else words.data_ptr(), epoch, stream)
        if err != 0:
            raise RuntimeError(f"task_scan kernel launch failed: CUDA error {err}")
        task_scan.launches += 1
    if submit is None:
        return counts[0], None, None
    return counts[0], counts[1], plist


task_scan.launches = 0
