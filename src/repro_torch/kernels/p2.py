"""The P² sketch's absorb as one hand-written Hopper kernel.

``p2_absorb`` absorbs a batch of observations into a
``repro_torch.simx.telemetry.QuantileSketch``: the streaming engine's
per-segment update of its delay sketch.  It is not a port of a TPU kernel
but of the reference's in-jit ``lax.scan`` over the batch
(``repro/simx/telemetry.py::sketch_absorb``), which in PyTorch is a loop
of about 80 small ops per observation.  The CUDA source is
``csrc/p2_sketch.cu``, compiled by ``build.py`` at its first launch and
called through ``ctypes``.  A sketch on the CPU goes to the plain version
(``telemetry.sketch_absorb``); one on a CUDA device launches the kernel or
raises.  A lane-batched sketch (the sharded steady state's, one sketch per
offered load) is absorbed in the same one launch, a block row per lane.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build

#: the most lanes one launch absorbs: the grid's y dimension
MAX_LANES = 65535


@lru_cache(maxsize=None)
def _library_fns():
    """The entry points of ``csrc/p2_sketch.cu`` (the absorb, and the SM
    clock probe), with every pointer and the stream as ``c_void_p``."""
    lib = build.load("p2_sketch")
    fn = lib.p2_absorb_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    clock = lib.p2_clock_launch
    clock.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    clock.restype = ctypes.c_int
    return fn, clock


def p2_absorb(sk, values: torch.Tensor, mask: torch.Tensor, cycles: torch.Tensor | None = None):
    """``sk`` with ``values[i]`` absorbed wherever ``mask[i]``, in index
    order: ``values`` float32[N] and ``mask`` bool[N] on the sketch's
    device.  A lane-batched sketch (fields ``[L, ...]``) takes ``[L, N]``
    values and mask, lane ``l``'s row into lane ``l``'s sketch, all lanes
    in one launch.  Returns a new sketch (the input's tensors are not
    written).  ``cycles``, an int64 [1] tensor on the card, receives the SM
    cycles of lane 0's walk over the valid values (the dependent chain
    alone; ``clock_hz`` turns them into time).

    ``launches`` counts the kernel launches (CPU calls launch nothing)."""
    from repro_torch.simx.telemetry import QuantileSketch, sketch_absorb

    dev = sk.q.device
    lead = tuple(sk.count.shape)            # () or (L,)
    if values.dim() != len(lead) + 1 or tuple(values.shape[:-1]) != lead \
            or mask.shape != values.shape:
        raise ValueError(
            f"a sketch of lanes {lead} takes values and mask of shape {lead} + (N,), "
            f"got {tuple(values.shape)} and {tuple(mask.shape)}")
    if values.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"values must be float32 and mask bool, got {values.dtype}, {mask.dtype}")
    if values.device != dev or mask.device != dev:
        raise ValueError(f"sketch on {dev}, values on {values.device}, mask on {mask.device}")
    if dev.type == "cpu":
        return sketch_absorb(sk, values, mask)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    fn, _ = _library_fns()
    n_q = sk.q.shape[-2]
    n_lanes = lead[0] if lead else 1
    if not 1 <= n_lanes <= MAX_LANES:
        raise ValueError(f"the kernel absorbs 1 to {MAX_LANES} lanes, got {n_lanes}")
    if cycles is not None and (cycles.shape != (1,) or cycles.dtype != torch.int64
                               or cycles.device != dev):
        raise ValueError("cycles must be an int64 [1] tensor on the sketch's device")
    want = [(t, lead + (n_q, 5), torch.float32) for t in (sk.q, sk.n, sk.npd, sk.dn)]
    want += [(sk.buf, lead + (5,), torch.float32), (sk.count, lead, torch.int32)]
    if any(t.shape != shape or t.dtype != dtype or t.device != dev for t, shape, dtype in want):
        raise ValueError("the sketch must hold float32 [Q, 5] cells, a float32 [5] buffer "
                         "and an int32 count per lane on one device")
    state = [t.contiguous().clone() for t in (sk.q, sk.n, sk.npd, sk.buf, sk.count)]
    q, n, npd, buf, count = state
    dn = sk.dn.contiguous()
    values, mask = values.contiguous(), mask.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), mask.data_ptr(), values.shape[-1], q.data_ptr(),
                 n.data_ptr(), npd.data_ptr(), dn.data_ptr(), buf.data_ptr(),
                 count.data_ptr(), n_q, n_lanes,
                 None if cycles is None else cycles.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"p2_sketch kernel launch failed: CUDA error {err}")
    p2_absorb.launches += 1
    return QuantileSketch(q=q, n=n, npd=npd, dn=sk.dn, buf=buf, count=count,
                          targets=sk.targets)


p2_absorb.launches = 0


def clock_hz(device: str | torch.device = "cuda", spin: int = 200_000_000) -> float:
    """The card's SM clock while one thread spins ``spin`` cycles, in Hz:
    ``clock64`` cycles over the global timer's nanoseconds."""
    _, clock = _library_fns()
    dev = torch.device(device)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = clock(spin, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p2_sketch clock probe failed: CUDA error {err}")
    cyc, ns = out.tolist()
    return cyc / ns * 1e9
