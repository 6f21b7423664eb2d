"""End-to-end training launcher (port of ``repro/launch/train.py``, with the
same options and printed lines, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --preset tiny \
      --steps 50 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --preset 100m \
      --steps 300 --batch 32 --seq 512 --ckpt-dir _build/ckpt

Presets scale the assigned architecture down while preserving its family
structure (MoE stays MoE, MLA stays MLA, SSD stays SSD):
  tiny : ~2M params  — CPU smoke
  100m : ~100M params — the end-to-end deliverable scale
  full : the exact assigned config

The model trains on the CUDA card unless ``--device cpu`` is given.
Fault tolerance: checkpoint/restart via --ckpt-dir (atomic publish, LATEST
pointer); kill and re-run with the same arguments to resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O


def scaled_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    if preset == "full":
        return cfg
    if preset == "tiny":
        return smoke_config(cfg)
    if preset != "100m":
        raise ValueError(preset)
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 12 if not cfg.attn_every else 13),
        d_model=768,
        d_ff=2048 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 32_000),
        loss_chunk=128,
    )
    if cfg.num_heads:
        kw.update(num_heads=12, num_kv_heads=max(1, min(cfg.num_kv_heads, 4)), head_dim=64)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), expert_d_ff=512,
            group_size=64,
        )
    if cfg.mla:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=128, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32,
        )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, headdim=32, chunk=64)
    if cfg.attn_every:
        kw["attn_every"] = 4
    return dataclasses.replace(cfg, **kw)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = scaled_config(get_config(args.arch), args.preset)
    if args.seq % cfg.loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=min(args.seq, cfg.loss_chunk))
    if cfg.ssm and args.seq % cfg.ssm.chunk:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=min(args.seq, cfg.ssm.chunk))
        )
    total, active = M.param_counts(cfg)
    print(f"arch={cfg.name} preset={args.preset} params={total/1e6:.1f}M "
          f"(active {active/1e6:.1f}M) batch={args.batch} seq={args.seq}")

    start = (C.latest_step(args.ckpt_dir) if args.ckpt_dir else None) or 0
    if start >= args.steps:
        print(f"nothing to do: the checkpoint in {args.ckpt_dir} is at step {start} "
              f"of --steps {args.steps}")
        return []
    opt = O.OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 10))
    data = batches(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    t0 = time.time()
    state, history = TL.train_loop(
        cfg, opt, data,
        steps=args.steps,
        seed=args.seed,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        log_every=max(1, args.steps // 20),
        device=dev,
    )
    for h in history:
        print(f"step {int(h['step']):5d}  loss {h['loss']:.4f}  "
              f"|g| {h['grad_norm']:.3f}  t {h['wall']:.1f}s")
    dt = time.time() - t0
    tokens = (args.steps - start) * args.batch * args.seq
    print(f"done: {args.steps - start} steps, {tokens} tokens, {tokens/dt:.0f} tok/s")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
