"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

81 Mamba2 layers; one *shared-weight* attention+MLP block is applied after
every 6th SSD layer (13 applications, 3 trailing SSD layers).  Deviation
noted in DESIGN.md: the shared attention uses a 4096-token sliding window so
the long_500k serving cell keeps a bounded ring-buffer cache.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2_7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    attn_every=6,
    attn_window=4096,
    ssm=SSMConfig(d_state=64, expand=2, headdim=64, d_conv=4, chunk=256),
)
