"""Serving launcher: Megha-scheduled continuous-batching decode.

Port of ``repro/launch/serve.py``, with the same options and defaults:

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 200 --pods 2 \
      --slots 16 --frontends 2 [--device cpu]

Slots are continuous-batching lanes; the Megha engine (frontends = GMs with
eventually-consistent fleet views, pod controllers = LMs with ground truth)
places each request on a lane, and slot hold times are simulated from the
requests' generation lengths.  The engine runs on the CUDA card unless
``--device cpu`` is given.  ``--real-decode`` (one pod's lanes running a
real tiny-model decode) needs the LM stack, which the port does not have
yet, and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.serve.engine import MeghaServeEngine, Request


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen15_05b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--frontends", type=int, default=2)
    ap.add_argument("--mean-gen", type=int, default=12)
    ap.add_argument("--arrival", type=float, default=8.0, help="requests/tick")
    ap.add_argument("--real-decode", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.real_decode:
        raise NotImplementedError(
            "--real-decode needs the LM stack, which is not ported yet "
            "(ROADMAP.md queue 1, item 15)"
        )

    rng = np.random.default_rng(args.seed)
    eng = MeghaServeEngine(
        num_frontends=args.frontends, num_pods=args.pods,
        slots_per_pod=args.slots, max_batch=args.slots * args.pods,
        device=args.device,
    )

    t0 = time.time()
    rid = 0
    while rid < args.requests:
        n = min(int(rng.poisson(args.arrival)), args.requests - rid)
        eng.submit([
            Request(rid + i, gen_len=1 + int(rng.poisson(args.mean_gen)))
            for i in range(n)
        ])
        rid += n
        eng.tick()
    stats = eng.run_until_drained()
    dt = time.time() - t0
    s = stats.summary()
    print(f"requests={s['completed']}/{args.requests} ticks={s['ticks']} "
          f"wall={dt:.1f}s ({s['completed']/dt:.0f} req/s) device={eng.device}")
    print(f"placement: inconsistency_ratio={s['inconsistency_ratio']:.4f} "
          f"repartitions={s['repartitions']} "
          f"queue delay mean={s['mean_queue_delay']:.2f} p95={s['p95_queue_delay']:.2f} ticks")
    return s


if __name__ == "__main__":
    main()
