"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality).

48 layers, d_model 2048, d_state 128, headdim 64, expand 2 (d_inner 4096,
64 SSD heads).  Runs the long_500k cell: O(1) decode state.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_13b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, d_conv=4, chunk=256),
    notes="attention-free; Megha technique applies unchanged (scheduler is arch-agnostic)",
)
