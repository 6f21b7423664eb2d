"""HuBERT-XLarge [arXiv:2106.07447]: 48L encoder-only audio transformer.

The conv waveform frontend is a STUB — ``input_specs`` supplies precomputed
frame embeddings (FRAME_DIM=512) which a learned projection lifts to d_model.
Objective: masked-unit prediction over 504 k-means units (we compute CE over
all frames; masking is a data-pipeline concern).  Plain (non-gated) GELU MLP,
bidirectional attention, no decode step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert_xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_act="gelu",
    gated_mlp=False,
    causal=False,
    use_rope=False,   # HuBERT uses a conv positional frontend (stubbed)
    frontend="frames",
    notes="encoder-only; decode shapes skipped",
)
