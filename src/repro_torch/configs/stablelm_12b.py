"""StableLM-2-12B [hf:stabilityai/stablelm-2-*]: 40L GQA kv=8."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
)
