"""Architecture + shape-cell configuration types (port of
``repro/configs/base.py``: the same fields, defaults and helpers, with the
``jnp`` dtypes as torch dtypes).

Each assigned architecture has a ``configs/<id>.py`` exporting ``CONFIG``;
``get_config(arch)`` resolves it.  ``smoke_config`` shrinks any config to a
CPU-runnable size preserving its family structure (MoE stays MoE, MLA stays
MLA, ...), for the per-arch smoke tests.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_experts: int = 0          # always-on experts (DeepSeek)
    dense_parallel: bool = False     # dense FFN residual in parallel (Arctic)
    first_k_dense: int = 0           # leading dense-MLP layers (DeepSeek)
    capacity_factor: float = 1.25
    group_size: int = 128            # tokens per dispatch group (GShard-style)
    dispatch: str = "einsum"         # "einsum" (GShard one-hot, baseline) |
                                     # "sort" (argsort gather/scatter: kills
                                     # the tokens*E*C*d dispatch FLOPs)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    d_conv: int = 4
    chunk: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 => d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True
    qkv_bias: bool = False
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: shared attn block per k SSM layers
    attn_window: int = 0             # sliding-window attention (0 = full)
    frontend: Optional[str] = None   # None | "patch" (VLM) | "frames" (audio)
    frontend_tokens: int = 576
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    cache_dtype: Any = None          # KV/conv cache dtype (None = compute);
                                     # e.g. torch.float8_e4m3fn for fp8 cache
    remat: bool = True
    remat_policy: str = "full"       # "full" | "dots" (save matmul outputs:
                                     # backward skips recomputing matmuls AND
                                     # their TP collectives, for more memory)
    loss_chunk: int = 512            # sequence chunk for chunked cross-entropy
    scan_layers: bool = True         # False: python-loop unroll (exact
                                     # cost_analysis; dry-run extrapolation)
    ssm_shard_constraints: bool = True  # keep SSD inner activations sharded
    notes: str = ""

    @property
    def head_dim_eff(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over the model
        axis (e.g. hubert 504 -> 512, mamba2 50280 -> 50432)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def applicable_shapes(cfg: ModelConfig) -> list[tuple[ShapeCell, Optional[str]]]:
    """All 4 cells with a skip reason (or None if runnable).

    - encoder-only archs have no autoregressive decode -> skip decode cells;
    - long_500k requires sub-quadratic sequence mixing -> SSM/hybrid only.
    """
    out = []
    for cell in SHAPES:
        reason = None
        if cfg.is_encoder_only and cell.kind == "decode":
            reason = "encoder-only: no autoregressive decode step"
        elif cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
            reason = "pure full-attention arch: 500k KV cache is out of scope (per assignment)"
        out.append((cell, reason))
    return out


ARCH_IDS = (
    "hubert_xlarge",
    "qwen15_05b",
    "gemma_7b",
    "llama3_8b",
    "stablelm_12b",
    "mamba2_13b",
    "llava_next_mistral_7b",
    "zamba2_7b",
    "arctic_480b",
    "deepseek_v2_lite_16b",
)


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink to CPU scale, preserving family structure."""
    kw: dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.attn_every else 7),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 503),  # odd on purpose: exercises padding
        loss_chunk=16,
        remat=False,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads, 2))
        kw["head_dim"] = 32
    if cfg.moe:
        kw["moe"] = replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            group_size=16,
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
        )
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, d_state=16, headdim=16, chunk=8)
    if cfg.attn_every:
        kw["attn_every"] = 3
    if cfg.attn_window:
        kw["attn_window"] = 16
    if cfg.frontend:
        kw["frontend_tokens"] = 8
    return replace(cfg, **kw)
