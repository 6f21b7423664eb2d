"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, 256k vocab, tied embeds."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma_7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_act="gelu",     # GeGLU
    tie_embeddings=True,
)
