"""Serve a small model with batched requests, scheduled by Megha (the
PyTorch port's counterpart of ``examples/serve_cluster.py``, with the same
defaults).

Demonstrates the paper's architecture as the control plane of an inference
fleet: 2 pods x 16 decode slots, 2 GM frontends with eventually-consistent
views, real KV-cache decode on the slots (tiny qwen-family model).  Runs on
the CUDA card; pass ``--device cpu`` to run on the CPU.  Any option given
overrides its default.

    PYTHONPATH=src python examples/torch_serve_cluster.py [--device cpu]
"""

import sys

from repro_torch.launch.serve import main

DEFAULTS = [
    "--arch", "qwen15_05b", "--requests", "120",
    "--pods", "2", "--slots", "16", "--frontends", "2",
    "--real-decode",
]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
