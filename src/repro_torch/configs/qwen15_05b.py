"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: 24L dense with QKV bias, tied embeds."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen15_05b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
