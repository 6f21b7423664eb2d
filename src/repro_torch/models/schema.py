"""Schema-driven parameters (port of ``repro/models/schema.py``): one
definition yields real init, abstract shapes, counts and PartitionSpecs.

Every model module describes its parameters as a nested dict of ``ParamDef``
leaves carrying a shape, a tuple of *logical axis names*, and an initializer.
The consumers:

  * ``init_params(schema, generator, device)`` -> nested dict of tensors
  * ``abstract_params(schema)``                -> the same on the meta device
  * ``param_pspecs(schema, rules)``            -> nested dict of ``P``
  * ``param_count`` / ``param_bytes``

``init_params`` follows the reference's rules leaf by leaf but draws from a
``torch.Generator``, so it matches the reference in distribution only
(``jax.random`` is not reproducible in torch).  To run the reference's
parameters, carry them across: ``params_from_numpy`` takes the reference's
tree with each leaf as a numpy array, ``params_to_numpy`` gives it back.

Logical -> mesh axis resolution (``ShardingRules``) applies the
reference's divisibility guard: a dimension that does not divide evenly
over its mesh axes falls back to replication (e.g. arctic's 56 heads on a
16-way model axis).  ``P`` is the reference's ``PartitionSpec``: one entry
per dim, a mesh axis, a tuple of axes or None; ``dist.sharding.named``
turns it into DTensor placements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "fan_in"  # fan_in | zeros | ones | normal:<std> | embed
    fan_axis: int = 0     # which dim is fan-in for fan_in init

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


Schema = dict  # nested dict[str, ParamDef | Schema]


def _leaf_paths(schema: Schema, prefix: tuple = ()):  # depth-first, ordered
    for k in sorted(schema):
        v = schema[k]
        if isinstance(v, ParamDef):
            yield prefix + (k,), v
        else:
            yield from _leaf_paths(v, prefix + (k,))


def map_schema(schema: Schema, fn: Callable[[ParamDef], Any]) -> dict:
    out: dict = {}
    for k, v in schema.items():
        out[k] = fn(v) if isinstance(v, ParamDef) else map_schema(v, fn)
    return out


def map_tree(tree: dict, fn: Callable[[Any], Any]) -> dict:
    """``fn`` on every leaf of a nested dict (a parameter tree or a cache),
    keeping the keys."""
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_leaves(tree: dict):
    """The leaves of a nested dict, depth-first in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_items(tree: dict, prefix: tuple = ()):
    """(path, leaf) of every leaf of a nested dict, depth-first in sorted-key
    order: the order ``jax.tree_util`` flattens a dict in, which numbers the
    reference's checkpoint leaves."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_from_items(items) -> dict:
    """The nested dict of (path, leaf) pairs (the inverse of ``tree_items``)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return out


def _init_leaf(pd: ParamDef, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=pd.dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=pd.dtype, device=device)
    if pd.init.startswith("normal:"):
        std = float(pd.init.split(":", 1)[1])
    elif pd.init == "embed":
        std = 0.02
    else:
        # fan_in: fan over fan_axis, excluding any leading stacking
        # ("layers"/"experts") axes, which are part of the batch
        fan = pd.shape[pd.fan_axis] if pd.shape else 1
        std = 1.0 / math.sqrt(max(1, fan))
    x = torch.randn(pd.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(std).to(pd.dtype)


def init_params(schema: Schema, generator: torch.Generator,
                device: str | torch.device | None = None, *,
                transform: Callable[[tuple, torch.Tensor], torch.Tensor] | None = None) -> dict:
    """Concrete parameters on ``device``, drawn leaf by leaf in
    ``_leaf_paths`` order from ``generator`` (which lives on that device).
    ``transform(path, leaf)``, when given, replaces each leaf as soon as it
    is drawn (so a cast copy never holds the drawn tree whole)."""
    dev = resolve_device(device)
    out: dict = {}
    for path, pd in _leaf_paths(schema):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        leaf = _init_leaf(pd, generator, dev)
        node[path[-1]] = leaf if transform is None else transform(path, leaf)
    return out


def abstract_params(schema: Schema) -> dict:
    """Shapes and dtypes without storage: tensors on the meta device."""
    return map_schema(schema, lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"))


class P(tuple):
    """A PartitionSpec: one entry per dim, each a mesh axis name, a tuple of
    axis names (major to minor) or None (replicated).  A tuple of one name
    is that name, as jax's ``PartitionSpec`` has it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis mapping with divisibility fallback.

    ``rules`` values may be a mesh axis name, a tuple of mesh axes, or None.
    """

    rules: dict[str, Any]
    mesh_axis_sizes: dict[str, int]

    def resolve(self, dim: int, axis: Optional[str]):
        if axis is None:
            return None
        target = self.rules.get(axis)
        if target is None:
            return None
        axes = target if isinstance(target, tuple) else (target,)
        if dim % math.prod(self.mesh_axis_sizes[a] for a in axes) != 0:
            return None  # fall back to replication (e.g. 56 heads / 16-way)
        return target

    def spec_for(self, pd: ParamDef) -> P:
        """Resolve each dim; a mesh axis may appear only once per spec, so
        later dims fall back to replication (e.g. expert weights [E, d, f]:
        E claims 'model' for expert parallelism, f then replicates)."""
        used: set = set()
        out = []
        for d, a in zip(pd.shape, pd.axes):
            r = self.resolve(d, a)
            axes = r if isinstance(r, tuple) else (r,) if r else ()
            if any(x in used for x in axes):
                out.append(None)
                continue
            used.update(axes)
            out.append(r)
        return P(*out)


def param_pspecs(schema: Schema, rules: ShardingRules) -> dict:
    return map_schema(schema, rules.spec_for)


def param_count(schema: Schema) -> int:
    return sum(math.prod(pd.shape) for _, pd in _leaf_paths(schema))


def param_bytes(schema: Schema) -> int:
    return sum(math.prod(pd.shape) * pd.dtype.itemsize for _, pd in _leaf_paths(schema))


# ---------------------------------------------------------------------------
# carrying parameters (and caches) across from the reference
# ---------------------------------------------------------------------------


def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return bf16_from_bits(a).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy of a read-only array


def params_from_numpy(tree: dict, device: str | torch.device | None = None) -> dict:
    """The reference's tree (the same nested keys, each leaf an
    ``np.asarray`` of the reference's array) as tensors on ``device``, each
    in its own dtype."""
    dev = resolve_device(device)
    return map_tree(tree, lambda a: _leaf_from_numpy(a, dev))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array in its own dtype, a bf16 one as its
    2-byte bit patterns (``uint16``: numpy has no bfloat16 of its own, and
    this needs no ``ml_dtypes``)."""
    t = t.detach().cpu()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    """Any 2-byte array (``to_host``'s ``uint16``, the reference's
    ``ml_dtypes.bfloat16`` or the ``|V2`` numpy reads that back as) as a
    bf16 tensor with the same bits."""
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    a = to_host(t)
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the reference's arrays carry it

        return a.view(ml_dtypes.bfloat16)
    return a


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: each leaf as a numpy array in
    its own dtype (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return map_tree(params, _leaf_to_numpy)
