"""Training step and loop (port of ``repro/train/loop.py``): gradients of
the chunked-CE loss, AdamW, optional gradient accumulation (microbatching),
parameters and moments updated in place.

``make_train_step(cfg, opt, accum_steps)`` builds the step function;
``train_loop`` is the host-side loop with checkpoint/restart fault
tolerance.  A step reads nothing back from the card: its metrics stay
device tensors, and the loop converts them to floats only at its log
steps.  ``train_state_pspecs`` gives the train state's ``P`` tree on a
mesh (``dist.sharding``), congruent with ``abstract_train_state``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.schema import (
    abstract_params,
    init_params,
    map_tree,
    tree_from_items,
    tree_items,
)
from repro_torch.train import optimizer as O


def init_train_state(cfg: ModelConfig, opt: O.OptConfig, generator: torch.Generator,
                     device: str | torch.device | None = None) -> dict:
    """Fresh parameters drawn from ``generator`` (which lives on ``device``,
    ``None``: the CUDA card) and a zero optimizer state."""
    params = init_params(M.model_schema(cfg), generator, device)
    return {"params": params, "opt": O.init_opt_state(params, opt)}


def abstract_train_state(cfg: ModelConfig, opt: O.OptConfig) -> dict:
    """The train state's shapes and dtypes on the meta device."""
    params = abstract_params(M.model_schema(cfg))
    zeros = lambda p: torch.empty(p.shape, dtype=opt.moment_dtype, device="meta")  # noqa: E731
    return {
        "params": params,
        "opt": {
            "m": map_tree(params, zeros),
            "v": map_tree(params, zeros),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
        },
    }


def train_state_pspecs(cfg: ModelConfig, mesh, *, fsdp: bool = False) -> dict:
    """The train state's ``P`` tree: the moments shard as their parameters."""
    from repro_torch.dist.sharding import model_pspecs
    from repro_torch.models.schema import P

    pspecs = model_pspecs(cfg, mesh, fsdp=fsdp)
    return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": P()}}


def make_train_step(
    cfg: ModelConfig, opt: O.OptConfig, accum_steps: int = 1
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    With ``accum_steps > 1`` the batch's leading dim is split into
    microbatches and the loss and gradients are summed in fp32, then
    divided (memory for a k-fold larger global batch at constant activation
    footprint).  The parameters and moments of ``state`` are updated in
    place; the metrics (loss, grad norm, step) are device tensors.
    """

    def value_and_grad(params: dict, batch: dict):
        items = list(tree_items(params))
        # the same storage, detached from any graph and recording this one
        leaves = [p.detach().requires_grad_() for _, p in items]
        tree = tree_from_items((path, t) for (path, _), t in zip(items, leaves))
        loss = M.loss_fn(tree, batch, cfg)
        # a leaf the loss does not read (the audio model's token table) gets
        # zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree_from_items((path, g) for (path, _), g in zip(items, grads))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            def split(x: torch.Tensor, i: int) -> torch.Tensor:
                b = x.shape[0] // accum_steps
                return x[i * b:(i + 1) * b]

            loss = torch.zeros((), dtype=torch.float32, device=next(iter(batch.values())).device)
            grads = map_tree(params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                           device=p.device))
            for i in range(accum_steps):
                micro = {k: split(x, i) if x.ndim >= 1 else x for k, x in batch.items()}
                l, g = value_and_grad(params, micro)
                loss = loss + l
                for (_, acc), (_, gi) in zip(tree_items(grads), tree_items(g)):
                    acc.add_(gi)
            loss = loss / accum_steps
            grads = map_tree(grads, lambda g: g / accum_steps)

        new_params, new_opt, gnorm = O.adamw_update(params, grads, state["opt"], opt)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt["step"]}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    opt: O.OptConfig,
    batches: Iterable[dict],
    *,
    steps: int,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 10,
    state: Optional[dict] = None,
    accum_steps: int = 1,
    device: str | torch.device | None = None,
) -> tuple[dict, list[dict]]:
    """Host loop: restore-or-init, steps, periodic checkpoints, on
    ``device`` (``None``: the CUDA card).

    Returns (final_state, metrics_history).
    """
    from repro_torch.train import checkpoint as C

    dev = resolve_device(device)
    start_step = 0
    if state is None:
        if checkpoint_dir is not None:
            state, start_step = C.restore_latest(checkpoint_dir, device=dev)
        if state is None:
            state = init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(seed),
                                     dev)

    step_fn = make_train_step(cfg, opt, accum_steps)
    history: list[dict] = []
    t0 = time.time()
    it = iter(batches)
    for i in range(start_step, steps):
        batch = next(it)
        state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i + 1 == steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall"] = time.time() - t0
            history.append(m)
        if checkpoint_dir is not None and (
            (i + 1) % checkpoint_every == 0 or i + 1 == steps
        ):
            C.save(checkpoint_dir, state, step=i + 1)
    return state, history
