"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``;
``_markov_tokens`` and the draws of ``batches`` are the reference's numpy
code, so every array is bitwise the reference's).

Generates structured (not i.i.d.-uniform) token streams so that training
loss actually falls: documents are Markov chains over a banded transition
matrix, seeded per (seed, step, host).  Shard-aware: each host materializes
only its slice of the global batch.  Batches are tensors on ``device``
(``None``: the CUDA card), frames and patches in the compute dtype.  On the
card each array goes up from pinned host memory without waiting for the
card (a copy from pageable memory would wait for the step before it).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import FRAME_DIM, PATCH_DIM


def _markov_tokens(rng: np.random.Generator, b: int, s: int, vocab: int) -> np.ndarray:
    """Banded-Markov documents: next token ~ N(prev, band) mod vocab."""
    band = max(2, vocab // 32)
    toks = np.empty((b, s + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, b)
    steps = rng.integers(-band, band + 1, (b, s))
    for t in range(s):
        toks[:, t + 1] = (toks[:, t] + steps[:, t]) % vocab
    return toks


def batches(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    *,
    seed: int = 0,
    host_index: int = 0,
    host_count: int = 1,
    device: str | torch.device | None = None,
) -> Iterator[dict]:
    """Infinite iterator of train batches (host-sharded slice)."""
    if batch_size % host_count:
        raise ValueError(f"batch {batch_size} % host_count {host_count} != 0")
    dev = resolve_device(device)
    local_b = batch_size // host_count

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.pin_memory() if dev.type == "cuda" else t).to(dev, non_blocking=True)

    step = 0
    while True:
        rng = np.random.default_rng((seed, step, host_index))
        if cfg.frontend == "frames":
            frames = rng.normal(size=(local_b, seq_len, FRAME_DIM)).astype(np.float32)
            labels = _markov_tokens(rng, local_b, seq_len, cfg.vocab_size)[:, :seq_len]
            yield {"frames": put(frames).to(cfg.compute_dtype), "labels": put(labels)}
        elif cfg.frontend == "patch":
            n_img = cfg.frontend_tokens
            toks = _markov_tokens(rng, local_b, seq_len - n_img, cfg.vocab_size)
            patches = rng.normal(size=(local_b, n_img, PATCH_DIM)).astype(np.float32)
            img_labels = np.full((local_b, n_img), -100, np.int32)
            yield {
                "tokens": put(toks[:, :-1]),
                "patches": put(patches).to(cfg.compute_dtype),
                "labels": put(np.concatenate([img_labels, toks[:, 1:]], axis=1)),
            }
        else:
            toks = _markov_tokens(rng, local_b, seq_len, cfg.vocab_size)
            yield {
                "tokens": put(toks[:, :-1]),
                "labels": put(toks[:, 1:]),
            }
        step += 1
