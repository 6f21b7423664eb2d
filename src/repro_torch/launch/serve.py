"""Serving launcher: Megha-scheduled continuous-batching decode.

Port of ``repro/launch/serve.py``, with the same options and defaults:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_05b \
      --requests 200 --pods 2 --slots 16 --frontends 2 [--real-decode] \
      [--device cpu]

Slots are continuous-batching lanes; the Megha engine (frontends = GMs with
eventually-consistent fleet views, pod controllers = LMs with ground truth)
places each request on a lane.  With --real-decode, one pod's lanes run an
actual tiny-model decode (one token per engine tick per active lane, the
arch's smoke config), demonstrating the full path: request -> Megha
placement -> KV-cache decode -> completion -> slot reuse.  The engine and
the model run on the CUDA card unless ``--device cpu`` is given.  Every
arch decodes: the attention families (dense, vlm, audio), MoE (arctic),
MLA with MoE (deepseek), SSM (mamba2) and hybrid (zamba2).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import decode as D
from repro_torch.models import model as M
from repro_torch.serve.engine import MeghaServeEngine, Request


class ModelRunner:
    """Real decode compute for one pod's slots (continuous batching).

    The configuration is the arch's smoke config, as in the reference;
    ``cfg=`` runs another (``chip_smoke.py`` runs the full width), and
    ``params=`` a tree of tensors (the tests feed the reference's, carried
    across with ``models.schema.params_from_numpy``), else the weights are
    drawn from ``seed`` on the device.
    The compute-dtype copy of the weights is made once, here: bitwise what
    the reference's per-use casts compute; it is the only copy the runner
    keeps.  Drawn weights are cast leaf by leaf as they are drawn
    (``model.init_compute_params``), so the parameter-dtype tree is never
    held whole (DeepSeek-V2-Lite's fp32 tree alone is 62.8 GB).  A tick
    reads nothing back from the card."""

    def __init__(self, arch: str, slots: int, max_len: int = 64, seed: int = 0, *,
                 device: str | torch.device | None = None,
                 cfg: ModelConfig | None = None, params: dict | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else smoke_config(get_config(arch))
        self.slots = slots
        if params is None:
            self.weights = M.init_compute_params(
                self.cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        else:
            self.weights = M.compute_params(
                M.LanguageModel(self.cfg, params, device=self.device).tree(), self.cfg)
        self.cache = D.init_cache(self.cfg, slots, max_len, self.device)
        self.tokens = torch.ones((slots, 1), dtype=torch.int32, device=self.device)
        self.logits: torch.Tensor | None = None
        self.pos = 0
        self.max_len = max_len

    def tick(self) -> None:
        if self.pos >= self.max_len:
            return
        with torch.inference_mode():
            self.logits, self.cache = D.decode_step(
                self.weights, self.cache, {"tokens": self.tokens, "pos": self.pos}, self.cfg)
            # the first maximum on ties, as jnp.argmax
            self.tokens = torch.argmax(self.logits, -1, keepdim=True).to(torch.int32)
        self.pos += 1


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

    rng = np.random.default_rng(args.seed)
    eng = MeghaServeEngine(
        num_frontends=args.frontends, num_pods=args.pods,
        slots_per_pod=args.slots, max_batch=args.slots * args.pods,
        device=args.device,
    )
    runner = ModelRunner(args.arch, args.slots, device=eng.device) if args.real_decode else None

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
        if runner is not None:
            runner.tick()
    stats = eng.run_until_drained()
    dt = time.time() - t0
    s = stats.summary()
    print(f"requests={s['completed']}/{args.requests} ticks={s['ticks']} "
          f"wall={dt:.1f}s ({s['completed']/dt:.0f} req/s) device={eng.device}")
    print(f"placement: inconsistency_ratio={s['inconsistency_ratio']:.4f} "
          f"repartitions={s['repartitions']} "
          f"queue delay mean={s['mean_queue_delay']:.2f} p95={s['p95_queue_delay']:.2f} ticks")
    if runner is not None:
        print(f"real decode: {runner.pos} tokens/lane on {args.slots} lanes "
              f"({args.arch} smoke config)")
    return s


if __name__ == "__main__":
    main()
