"""PyTorch/CUDA port of the simx scheduling simulator.

A second package beside the JAX reference (``repro``), laid out with the
same module names so each counterpart is easy to find
(``repro_torch/simx/megha.py`` <-> ``repro/simx/megha.py``).  It imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of ``repro``: the
pure-Python pieces it needs (workload model, metrics records) are kept as
its own copies.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
