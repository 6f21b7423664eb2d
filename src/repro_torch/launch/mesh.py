"""Device meshes for the dry run and the distribution specs (port of
``repro/launch/mesh.py``).

A ``Mesh`` is a plain record of axis names and sizes: the specs of
``dist/sharding.py`` read nothing else, and the dry run traces on the meta
device, so no card or process group is needed to build one.  ``with mesh:``
makes it the ambient mesh that ``models.layers.constrain`` resolves
against, as the reference's ``with mesh:`` does.

Production layout, for H100 nodes (DGX H100: 8 GPUs joined all to all by
NVLink, the nodes by InfiniBand):

  single : (32, 8)     axes ("data", "model")          = 256 GPUs
  multi  : (2, 32, 8)  axes ("pod", "data", "model")   = 512 GPUs

The reference keeps "model" inside a TPU pod's (16, 16) torus; on H100 the
fast domain is one 8-GPU node, so the tensor and expert collectives of
"model" stay on NVLink and "data" (and "pod") carry only data parallelism
over the network.  The spec functions take any axis sizes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

#: the ambient mesh (``with mesh:``), None outside one
ambient: "Mesh | None" = None


class Mesh:
    """Axis names and sizes; ``with mesh:`` sets the ambient mesh."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self._outer: list = []

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.shape)

    def __enter__(self) -> "Mesh":
        global ambient
        self._outer.append(ambient)
        ambient = self
        return self

    def __exit__(self, *exc) -> None:
        global ambient
        ambient = self._outer.pop()

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 32, 8), ("pod", "data", "model"))
    return Mesh((32, 8), ("data", "model"))


def make_host_mesh(model_parallel: int = 1, device: str | torch.device | None = None) -> Mesh:
    """A ("data", "model") mesh over the devices there are: every card of
    this host (``device=None``: raises without one), or one CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    mp = max(1, min(model_parallel, n))
    return Mesh((n // mp, mp), ("data", "model"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
