"""AdamW written out on tensors (port of ``repro/train/optimizer.py``; no
optimizer library).

The reference's math, term for term: weight decay inside ``delta``, bias
corrections from an int32 step held on the device, the clip scale as a
tensor.  ``torch.optim.AdamW`` is not used: it decays the weights apart
from the step and adds epsilon after the bias correction of ``v``.
Moments are stored in ``moment_dtype``: fp32 by default, bf16 for
memory-bound giants (arctic-480b), where 2+2 bytes per parameter of bf16
moments is the difference between fitting and not.

``adamw_update`` updates the parameters and moments in place (the
counterpart of the reference's donated buffers) and reads nothing back
from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.schema import map_tree, tree_items


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zero moments shaped like ``params`` (on their devices) and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    device = next(leaf for _, leaf in tree_items(params)).device
    return {
        "m": map_tree(params, zeros),
        "v": map_tree(params, zeros),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    # linear warmup; `step` is the post-increment step count (1-based)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, the leaves summed
    in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for _, g in tree_items(tree)))


def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: OptConfig):
    """One AdamW step; returns (params, opt_state, grad_norm).  The leaves
    of ``params`` and of the moments are updated in place (under
    ``torch.no_grad``); ``opt_state["step"]`` is a new tensor."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip
                 else 1.0)
        lr = _schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        stepf = step.float()
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        for (_, p), (_, g), (_, m), (_, v) in zip(tree_items(params), tree_items(grads),
                                                  tree_items(opt_state["m"]),
                                                  tree_items(opt_state["v"])):
            g = g.float() * scale
            m32 = m.float() * b1 + (1 - b1) * g
            v32 = v.float() * b2 + (1 - b2) * g * g
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, gnorm
