"""End-to-end training example (the PyTorch port's counterpart of
``examples/train_100m.py``, with the same defaults): a llama3-family model
with checkpoint/restart.  Trains on the CUDA card; pass ``--device cpu`` to
train on the CPU.  Any option given overrides its default; pass
``--preset 100m --steps 300`` for the ~100M-parameter, few-hundred-step run.
Checkpoints go to the checkout's ``_build/torch_train_example/`` unless
``--ckpt-dir`` says otherwise; a second run resumes from them (and has
nothing to do once the last step is saved: delete the directory to train
afresh).

    PYTHONPATH=src python examples/torch_train_100m.py [--device cpu]
"""

import sys
from pathlib import Path

from repro_torch.launch.train import main

CKPT_DIR = Path(__file__).resolve().parent.parent / "_build" / "torch_train_example"

DEFAULTS = [
    "--arch", "llama3_8b", "--preset", "tiny",
    "--steps", "30", "--batch", "4", "--seq", "64",
    "--ckpt-dir", str(CKPT_DIR),
]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
