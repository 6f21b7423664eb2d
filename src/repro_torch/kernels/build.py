"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` (listed in
``.gitignore``), named by a hash of its source, the headers it may include
(every ``csrc/*.cuh``) and its flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Nothing here runs at import: the
CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class BuildInfo:
    """What one kernel build did: the library, how long ``nvcc`` took (0
    when an earlier build of the same source was reused) and ``ptxas``'s
    registers / shared memory / spills per compiled kernel."""

    name: str
    library: Path
    nvcc_seconds: float
    cached: bool
    ptxas: list[dict] = field(default_factory=list)


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def parse_ptxas(log: str) -> list[dict]:
    """Per-kernel registers, static shared memory and spill bytes from
    ``nvcc -Xptxas -v`` output."""
    out: list[dict] = []
    cur: dict | None = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1), "registers": None,
                   "smem_bytes": 0, "spill_bytes": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def source_digest(name: str, csrc: Path = CSRC_DIR) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` (by name and
    content) and ``NVCC_FLAGS``: what the library built from them depends
    on."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags is already in ``_build/``; raise with ``nvcc``'s output if the
    compile fails."""
    src = CSRC_DIR / f"{name}.cu"
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildInfo(name, lib, 0.0, True, parse_ptxas(log))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent build of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(name, lib, seconds, False, parse_ptxas(log))


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  One
    load per process: the library stays mapped for the process's life."""
    return ctypes.CDLL(str(build(name).library))
