"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434]: MLA + fine-grained MoE.

MLA: kv_lora_rank 512, per-head 128 nope + 64 rope query dims, absorbed
decode (latent-only KV cache).  MoE: 64 routed experts top-6 + 2 shared
experts, first layer dense (d_ff 10944).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,   # informational; MLA replaces GQA
    d_ff=10_944,       # dense first layer / reference FFN width
    vocab_size=102_400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        shared_experts=2,
        first_k_dense=1,
        group_size=128,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)
