"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, and
with ``--trace 1`` ``breakdown``; then ``card`` and, last, ``checks``: each
compared number beside its limit).  The lines before it break ``setup_s``
down.  The compared numbers are also the last lines of standard error.  The
run exits with another code than 0, and prints no result, without enough
CUDA cards or when JAX or the JAX package was loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    # the host runs one launching thread; no idle pool threads beside it
    torch.set_num_threads(1)

    marks = {"start": _START, "imports": time.perf_counter()}
    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_init"] = time.perf_counter()
    code, result, out_lines, err_lines = harness.execute(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", marks)
    for line in out_lines:
        print(line)
    for line in err_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if result is not None:
        print(harness.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
