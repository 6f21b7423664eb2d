"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The anyres vision tower is a STUB: ``input_specs`` supplies 576 projected
patch embeddings (PATCH_DIM=1024) per image which are prepended to the token
stream; labels at image positions are -100 (masked from the loss).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_mistral_7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_tokens=576,
)
