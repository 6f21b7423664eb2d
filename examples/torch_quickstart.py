"""Quickstart on the PyTorch/CUDA port (``src/repro_torch``): the paper in
a few minutes, the four sections of ``examples/quickstart.py``.

1. Megha against Sparrow/Eagle/Pigeon on a trace-like workload (Fig. 3),
   on the event backend.
2. The simx Fig. 2 sweep with its overhead columns: delay next to
   utilisation, control messages and the inconsistency rate.
3. Eventual consistency at work: two GMs collide on a stale view, and the
   LM's piggyback repairs it.
4. The hand-written match kernel (``match_tasks``, CUDA) at 50,000 lanes,
   checked bitwise against its plain PyTorch version.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # no card

Sections 2-4 run on ``--device`` (default: the CUDA card, raising without
one).  On the CPU section 4 runs the plain version, and says so.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import fastpath as FP  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import match, ops, ref  # noqa: E402
from repro_torch.sim.simulator import run_simulation  # noqa: E402
from repro_torch.simx import fig2_sweep  # noqa: E402
from repro_torch.workload.synth import yahoo_like_trace  # noqa: E402

#: section 1's trace (the reference quickstart's) and a small one for tests
TRACE = dict(num_jobs=600, total_tasks=9000, load=0.85, num_workers=1504, seed=1)
TRACE_SMALL = dict(num_jobs=60, total_tasks=900, load=0.85, num_workers=1504, seed=1)
#: section 2's grid point
SWEEP = dict(loads=(0.8,), num_seeds=1, num_workers=256, num_jobs=16, tasks_per_job=64,
             dt=0.05)
SWEEP_SMALL = dict(SWEEP, num_jobs=8, tasks_per_job=32)
MEGHA_KW = dict(num_gms=4, num_lms=4, heartbeat_interval=1.0)
SWEEP_RULES = ("megha", "sparrow", "oracle")
#: section 3's fleet and section 4's bitmap
GM_WORKERS = 4096
MATCH_LANES = 50_000


def _rule(line: str = "=") -> None:
    print(line * 70)


def section_events(trace: dict) -> dict:
    _rule()
    print(f"1) 4-way scheduler comparison (scaled Yahoo-like trace, "
          f"{trace['num_workers']} workers, event backend)")
    _rule()
    wl = yahoo_like_trace(**trace)
    results = {}
    for sched in ("megha", "sparrow", "eagle", "pigeon"):
        s = run_simulation(sched, wl, num_workers=trace["num_workers"]).summary()
        results[sched] = s
        print(f"  {sched:8s} median={s['all_median_delay']:.4f}s "
              f"p95={s['all_p95_delay']:.4f}s mean={s['all_mean_delay']:.4f}s "
              f"(inconsistencies/task={s['inconsistency_ratio']:.3f})")
    for other in ("sparrow", "eagle", "pigeon"):
        f = results[other]["all_mean_delay"] / results["megha"]["all_mean_delay"]
        print(f"  -> Megha reduces mean delay vs {other} by {f:.1f}x")
    return results


def section_sweep(spec: dict, device, draws: dict | None = None) -> dict:
    _rule()
    print(f"2) simx sweep: delay AND the overhead it buys ({spec['num_workers']} workers, "
          f"load {spec['loads'][0]}, on {device})")
    _rule()
    print(f"  {'scheduler':8s} {'p50':>7s} {'p95':>7s} {'util':>6s} "
          f"{'msgs':>7s} {'inc/task':>8s}")
    rows = {}
    for sched in SWEEP_RULES:
        kw = MEGHA_KW if sched == "megha" else {}
        r = fig2_sweep(sched, device=device, draws=(draws or {}).get(sched), **spec, **kw)
        rows[sched] = r
        print(f"  {sched:8s} {float(r['p50'][0, 0]):7.3f} "
              f"{float(r['p95'][0, 0]):7.3f} {float(r['mean_util'][0, 0]):6.3f} "
              f"{int(r['messages'][0, 0]):7d} "
              f"{float(r['inconsistency_rate'][0, 0]):8.4f}")
    print("  -> megha trades inconsistency-repair traffic for oracle-like "
          "delay; sparrow pays in probe messages instead")
    return rows


def section_consistency(device) -> dict:
    _rule()
    print("3) Eventually-consistent state: two GMs collide on a stale view")
    _rule()
    orders = FP.make_orders(GM_WORKERS, num_gms=4, num_lms=4, seed=0, device=device)
    truth = torch.ones(GM_WORKERS, dtype=torch.bool, device=device)
    fresh = torch.ones(GM_WORKERS, dtype=torch.bool, device=device)
    r1 = FP.gm_round(truth, fresh, orders[0], 3000, max_tasks=4096)
    r2 = FP.gm_round(r1.truth, fresh, orders[1], 3000, max_tasks=4096)
    out = dict(
        a_placed=int((r1.workers >= 0).sum()), a_inconsistent=int(r1.n_inconsistent),
        b_placed=int((r2.workers >= 0).sum()), b_inconsistent=int(r2.n_inconsistent),
        b_view_repaired=bool(torch.equal(r2.view, r2.truth)))
    print(f"  GM_A placed {out['a_placed']} tasks, "
          f"{out['a_inconsistent']} inconsistencies (fresh view)")
    print(f"  GM_B placed {out['b_placed']} tasks with a STALE view: "
          f"{out['b_inconsistent']} inconsistencies -> repaired by LM piggyback")
    print(f"  GM_B view now equals ground truth: {out['b_view_repaired']}")
    return out


def section_kernel(device) -> dict:
    """The match kernel at 50,000 lanes against its plain version.  The
    wrapper launches the CUDA kernel for a tensor on the card; on the CPU
    it is the plain version, and this section says so."""
    _rule()
    on_card = device.type == "cuda"
    what = ("the hand-written CUDA kernel vs its plain version" if on_card
            else "no card, so the plain version only")
    print(f"4) match_tasks at {MATCH_LANES} lanes: {what}")
    _rule()
    rng = np.random.default_rng(0)
    avail = torch.from_numpy((rng.random(MATCH_LANES) < 0.3).astype(np.int8)).to(device)
    before = match.match_tasks.launches
    a1, p1 = ops.match_tasks(avail, 1000, 1024, use_kernel=True)
    launches = match.match_tasks.launches - before
    a2, p2 = ref.match_tasks_ref(avail, 1000, 1024)
    equal = bool(torch.equal(a1, a2) and torch.equal(p1, p2))
    if on_card and launches != 1:
        raise RuntimeError(f"the kernel wrapper launched {launches} kernels, not 1")
    if not on_card:
        print("  ran the plain version on the CPU: the kernel runs only on a CUDA tensor")
    print(f"  {MATCH_LANES}-worker bitmap, 1000 tasks: kernel launches={launches}, "
          f"equal to the plain version: {equal}, placed={int(p1)}")
    if not equal:
        raise RuntimeError("match_tasks disagrees with its plain version")
    return dict(device=device.type, kernel_launches=launches, equal=equal, placed=int(p1))


def main(device=None, small: bool = False, draws: dict | None = None) -> dict:
    """Run the four sections on ``device`` (None: the CUDA card); ``small``
    shrinks sections 1 and 2 for a quick check.  ``draws`` feeds a rule's
    random draws to section 2's sweep (``{rule: draws}``, as
    ``fig2_sweep(draws=)``), e.g. the reference's.  Returns every
    section's numbers."""
    dev = resolve_device(device)
    out = dict(events=section_events(TRACE_SMALL if small else TRACE))
    print()
    out["sweep"] = section_sweep(SWEEP_SMALL if small else SWEEP, dev, draws)
    print()
    out["consistency"] = section_consistency(dev)
    print()
    out["kernel"] = section_kernel(dev)
    print("done.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--small", action="store_true", help="shrink sections 1 and 2")
    args = ap.parse_args()
    main(args.device, small=args.small)
