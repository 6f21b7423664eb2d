"""The readings the limits of ``portbench/checks/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each of ``--seeds``, in one process: the cell's inputs, one grid of the
timed path and the reference at the checked points, then every compared
number (the program's readings: the lower end of each limit).  For each of
``--control-seeds``: the control, which is the plain reference computed with
its times in bfloat16, the precision next below the configuration's
float32, put in the program's place and compared the same way (the upper
end).  One JSON line per seed; nothing is judged.  Needs the CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(run, time_dtype) -> dict:
    """The compared numbers with the reference in ``time_dtype`` put in the
    program's place, at the checked points of ``run``."""
    from portbench import judge

    ref_finish, ref_summary = run.reference()
    ctl_finish, ctl_summary = run.reference(time_dtype=time_dtype)
    # the control ran the checked points only: they are its whole grid
    return judge.numbers([ctl_summary], list(range(len(run.checked))), ctl_finish,
                         ref_finish, ref_summary, run.inputs.num_tasks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    cell = harness.resolve(ROOT, args.workload)
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            marks = {"start": t0, "imports": t0, "cuda_init": t0}
            run = harness.Run(cell, seed, 0.0, False, "cuda", marks)
            run.setup()
            walls = []
            if kind == "program":
                run.window()
                run.compare()
                values, walls = run.values, run.walls
                values["borrow_rounds"] = run.borrow_rounds
            else:
                values = control_numbers(run, torch.bfloat16)
            print(json.dumps(dict(workload=args.workload, kind=kind, seed=seed,
                                  checked=run.checked, seconds=time.perf_counter() - t0,
                                  grid_walls=walls,
                                  **values)), flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
