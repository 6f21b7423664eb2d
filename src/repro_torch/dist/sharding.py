"""Canonical sharding policy (port of ``repro/dist/sharding.py``):
PartitionSpec trees for params, caches and batches.

One place owns the logical-axis -> mesh-axis mapping so the dry run, the
train loop and the serving engine agree on layouts:

  * ``model_pspecs``  — parameter specs from the schema's logical axes
                        (tensor parallel over "model"; optional FSDP shards
                        the "embed" axis over "data").
  * ``cache_pspecs``  — decode-cache specs congruent with
                        ``decode.cache_spec`` (batch over the data axes, KV
                        heads / channels over "model" where divisible).
  * ``batch_pspecs``  — input-batch specs congruent with
                        ``decode.input_specs`` (leading batch dim over the
                        data axes).
  * ``batch_axes``    — the data-parallel mesh axes ("data", plus "pod" on
                        the multi-pod mesh).
  * ``named``         — map a ``P`` tree to DTensor placements: per leaf a
                        tuple of ``Shard(dim)`` / ``Replicate()``, one per
                        mesh axis, what ``distribute_tensor`` takes.
  * ``local_shape``   — the shape of one device's shard under placements
                        (``NamedSharding.shard_shape``).

Every assignment applies the same divisibility guard as
``schema.ShardingRules``: a dim that does not divide its mesh axes falls
back to replication rather than erroring.  Nothing here needs a process
group: the specs read only the mesh's axis names and sizes.
"""

from __future__ import annotations

import math
from typing import Any, Union

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes
from repro_torch.models.schema import P, ShardingRules, map_tree, param_pspecs

#: Logical parameter axes that carry tensor/expert parallelism.
MODEL_AXES = ("vocab", "heads", "kv_heads", "mlp", "experts", "ssm_inner")


def batch_axes(mesh: Mesh) -> Union[str, tuple[str, ...]]:
    """The mesh axes carrying data parallelism (valid inside a P())."""
    if "pod" in mesh.axis_names:
        return ("pod", "data")
    return "data"


def _axes(a) -> tuple:
    return a if isinstance(a, tuple) else (a,)


def dp_size(mesh: Mesh) -> int:
    """The number of data-parallel replicas (the product of batch_axes)."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(batch_axes(mesh)))


def sharding_rules(mesh: Mesh, *, fsdp: bool = False) -> ShardingRules:
    """The repo-wide logical->mesh rule set."""
    rules: dict[str, Any] = {a: "model" for a in MODEL_AXES}
    rules.update({"embed": "data" if fsdp else None, "head_dim": None, "layers": None})
    return ShardingRules(rules=rules, mesh_axis_sizes=mesh_axis_sizes(mesh))


def model_pspecs(cfg: ModelConfig, mesh: Mesh, *, fsdp: bool = False) -> dict:
    """The ``P`` tree of the model parameters of ``cfg``."""
    from repro_torch.models import model as M  # deferred: model imports are heavy

    return param_pspecs(M.model_schema(cfg), sharding_rules(mesh, fsdp=fsdp))


def placements(mesh: Mesh, spec: P) -> tuple:
    """One DTensor placement per mesh axis: ``Shard(dim)`` where ``spec``
    puts that axis on ``dim``, else ``Replicate()``."""
    on = {a: d for d, part in enumerate(spec) if part is not None for a in _axes(part)}
    return tuple(Shard(on[a]) if a in on else Replicate() for a in mesh.axis_names)


def named(mesh: Mesh, tree):
    """Map every ``P`` leaf of ``tree`` (a nested dict, or one ``P``) to its
    placements on ``mesh``."""
    if isinstance(tree, P):
        return placements(mesh, tree)
    return map_tree(tree, lambda s: placements(mesh, s))


def local_shape(shape, places: tuple, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one device's shard of ``shape`` under ``places``
    (``named``'s placements); a sharded dim must divide evenly."""
    out = list(shape)
    for n, pl in zip(mesh.shape, places):
        if isinstance(pl, Shard):
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not divide over {n}")
            out[pl.dim] //= n
    return tuple(out)


def _guarded(dim: int, axes, sizes: dict[str, int]):
    """Shard ``dim`` over ``axes`` only if it divides their product."""
    total = math.prod(sizes.get(a, 1) for a in _axes(axes))
    if total <= 1 or dim % total != 0:
        return None
    return axes


#: cache key -> (index of the batch dim, index of the "model"-sharded dim).
#: Negative model indices count from the right; None = replicate.
_CACHE_LAYOUT: dict[str, tuple[int, Any]] = {
    # attention KV: [L, B, T, KV, D] — batch at 1, kv heads at -2
    "k": (1, -2),
    "v": (1, -2),
    "dense_k": (1, -2),
    "dense_v": (1, -2),
    # hybrid shared-attn KV: [G, B, T, KV, D]
    "attn_k": (1, -2),
    "attn_v": (1, -2),
    # MLA absorbed latent: [L, B, T, r+rope] — latent width rarely divides
    "latent": (1, -1),
    "dense_latent": (1, -1),
    # SSM recurrent state: [L, B, H, P, N] — heads at 2
    "state": (1, 2),
    "t_state": (1, 2),
    # SSM conv buffer: [L, B, w, C] — conv channels last
    "conv": (1, -1),
    "t_conv": (1, -1),
    # hybrid per-group SSM: [G, per, B, ...]
    "g_state": (2, 3),
    "g_conv": (2, -1),
}


def cache_pspecs(cfg: ModelConfig, mesh: Mesh, batch: int, seq_len: int) -> dict:
    """``P``s congruent with ``decode.cache_spec(cfg, batch, seq_len)``."""
    from repro_torch.models import decode as D

    sizes = mesh_axis_sizes(mesh)
    ba = batch_axes(mesh)
    out = {}
    for key, (shape, _) in D.cache_spec(cfg, batch, seq_len).items():
        rank = len(shape)
        parts: list[Any] = [None] * rank
        bidx, midx = _CACHE_LAYOUT[key]
        parts[bidx] = _guarded(shape[bidx], ba, sizes)
        if midx is not None:
            m = midx % rank
            if m != bidx:
                parts[m] = _guarded(shape[m], "model", sizes)
        out[key] = P(*parts)
    return out


def batch_pspecs(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh) -> dict:
    """``P``s congruent with ``decode.input_specs(cfg, cell)``: leading
    batch dim over the data axes, everything else replicated."""
    from repro_torch.models import decode as D

    sizes = mesh_axis_sizes(mesh)
    ba = batch_axes(mesh)
    out = {}
    for key, t in D.input_specs(cfg, cell).items():
        if t.dim() == 0:
            out[key] = P()
            continue
        parts: list[Any] = [None] * t.dim()
        parts[0] = _guarded(t.shape[0], ba, sizes)
        out[key] = P(*parts)
    return out
