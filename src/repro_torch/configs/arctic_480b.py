"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid residual: every layer runs a dense FFN *in parallel* with a
128-expert top-2 MoE.  56 heads do not divide the 16-way model axis, so
attention weights fall back to replication (see DESIGN.md §sharding);
bf16 params + FSDP keep the 480B footprint per-chip feasible.
"""

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic_480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_parallel=True,
        group_size=128,
    ),
    param_dtype=torch.bfloat16,
)
