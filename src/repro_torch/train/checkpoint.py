"""Checkpoint/restart (port of ``repro/train/checkpoint.py``): a manifest
plus one ``.npy`` payload per leaf, in the reference's layout.

Layout:
  <dir>/step_<N>/manifest.json   — tree paths, shapes, dtypes, step
  <dir>/step_<N>/leaf_<i>.npy    — one array per leaf (copied to the host)
  <dir>/LATEST                   — atomic pointer to the newest complete step

Fault-tolerance contract: a checkpoint directory is visible via LATEST only
after every leaf and the manifest are fully written (write-then-rename), so
a crash mid-save never corrupts restore.

The leaves are numbered in the reference's order (``schema.tree_items``:
depth-first, sorted keys, as ``jax.tree_util`` flattens a dict) under the
same path strings (``params/blocks/attn/wq``, ``opt/step``), so each
package restores the other's checkpoints.  A bf16 leaf is written as its
2-byte bit pattern (``uint16``) with ``"dtype": "bfloat16"`` in the
manifest, and read back from either that or the ``|V2`` payload the
reference's ``ml_dtypes`` arrays save as; neither way needs ``ml_dtypes``.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.schema import bf16_from_bits, to_host, tree_from_items, tree_items


def save(ckpt_dir: str | Path, state: dict, step: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".step_{step}_"))
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree_items(state)):
        np.save(tmp / f"leaf_{i}.npy", to_host(leaf))
        manifest["leaves"].append({"path": "/".join(path), "shape": list(leaf.shape),
                                   "dtype": str(leaf.dtype).removeprefix("torch.")})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    latest_tmp = ckpt_dir / ".LATEST.tmp"
    latest_tmp.write_text(str(step))
    latest_tmp.rename(ckpt_dir / "LATEST")
    return final


def restore(ckpt_dir: str | Path, step: int, like: Optional[dict] = None, *,
            device: str | torch.device | None = None) -> dict:
    """Rebuild the tree saved at ``step`` with its leaves on ``device``
    (``None``: the CUDA card).  If ``like`` is given, its structure is used
    (and leaf count and shapes validated); otherwise a nested dict
    following the manifest paths is returned."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    metas = manifest["leaves"]
    arrays = [np.load(d / f"leaf_{i}.npy") for i in range(len(metas))]
    if like is not None:
        items = list(tree_items(like))
        if len(items) != len(arrays):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, template has {len(items)}"
            )
        for a, (_, leaf), meta in zip(arrays, items, metas):
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {meta['path']}: {a.shape} vs "
                                 f"{tuple(leaf.shape)}")
        paths = [path for path, _ in items]
    else:
        paths = [tuple(meta["path"].split("/")) for meta in metas]
    return tree_from_items(
        (path, (bf16_from_bits(a) if meta["dtype"] == "bfloat16" else torch.from_numpy(a)).to(dev))
        for path, a, meta in zip(paths, arrays, metas))


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def restore_latest(ckpt_dir: str | Path, like: Optional[dict] = None, *,
                   device: str | torch.device | None = None):
    """Returns (state_or_None, start_step)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, 0
    return restore(ckpt_dir, step, like, device=device), step
