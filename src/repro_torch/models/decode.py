"""Autoregressive decode (port of ``repro/models/decode.py``): per-family
caches and the one-token step.

Cache shapes (leading L = stacked layer axis):

  attention (dense/moe/vlm): k,v     [L, B, T, KV, D]      cache dtype
                             (+ dense_k, dense_v for leading dense layers)
  mla (deepseek)           : latent  [L, B, T, r+rope]     cache dtype (absorbed)
                             (+ dense_latent for the leading dense layers)
  ssm (mamba2)             : state   [L, B, H, P, N] fp32; conv [L, B, w, C]
  hybrid (zamba2)          : groups' ssm states [G, P_g, ...] + shared-attn
                             kv per group application [G, B, Tw, KV, D]

T = min(seq_len, attn_window): sliding-window archs keep a ring buffer.
The cache dtype is ``cfg.cache_dtype`` (default the compute dtype); the SSM
recurrent state stays fp32.  ``input_specs`` gives the dry run's inputs
as meta tensors (no allocation); ``init_cache(..., device="meta")`` its
cache.

The step takes its position as a host ``int`` so that it reads nothing
back from the card, and writes every cache (keys and values, latents, SSM
states and conv windows) in place (the reference donates the cache to its
jitted step, so the two agree), returning the same cache with the logits.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.model import (
    FRAME_DIM,
    PATCH_DIM,
    _unembed_table,
    hybrid_layout,
    layer_views,
)


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.attn_window) if cfg.attn_window else seq_len


def _ssm_state_shapes(cfg: ModelConfig, batch: int):
    _, nheads, conv_dim = SSM._dims(cfg)
    s = cfg.ssm
    return (
        (batch, nheads, s.headdim, s.d_state),
        (batch, s.d_conv - 1, conv_dim),
    )


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The cache's shapes and dtypes, ``{name: (shape, dtype)}``, with no
    allocation."""
    t = cache_len(cfg, seq_len)
    cdt = cfg.cache_dtype or cfg.compute_dtype
    kv = (batch, t, cfg.num_kv_heads, cfg.head_dim_eff)

    if cfg.family == "ssm":
        st, cv = _ssm_state_shapes(cfg, batch)
        nl = cfg.num_layers
        return {"state": ((nl,) + st, torch.float32), "conv": ((nl,) + cv, cdt)}
    if cfg.family == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        st, cv = _ssm_state_shapes(cfg, batch)
        out = {
            "g_state": ((groups, per) + st, torch.float32),
            "g_conv": ((groups, per) + cv, cdt),
            "attn_k": ((groups,) + kv, cdt),
            "attn_v": ((groups,) + kv, cdt),
        }
        if tail:
            out["t_state"] = ((tail,) + st, torch.float32)
            out["t_conv"] = ((tail,) + cv, cdt)
        return out
    nd = cfg.moe.first_k_dense if cfg.moe else 0
    if cfg.mla:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        out = {"latent": ((cfg.num_layers - nd, batch, t, width), cdt)}
        if nd:
            out["dense_latent"] = ((nd, batch, t, width), cdt)
        return out
    out = {"k": ((cfg.num_layers - nd,) + kv, cdt), "v": ((cfg.num_layers - nd,) + kv, cdt)}
    if nd:
        out["dense_k"] = ((nd,) + kv, cdt)
        out["dense_v"] = ((nd,) + kv, cdt)
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in cache_spec(cfg, batch, seq_len).items()}


# --------------------------------------------------------------------------
# per-block decode bodies (each writes its cache slices in place)
# --------------------------------------------------------------------------

def _ffn(bp, x, cfg: ModelConfig):
    h = L.rmsnorm_apply(bp["ln2"], x)
    if "router" in bp["ffn"]:
        return MOE.moe_apply(bp["ffn"], h, cfg)[0]
    return L.mlp_apply(bp["ffn"], h, cfg)


def _attn_block_decode(bp, x, ck, cv, pos: int, cfg: ModelConfig):
    a, _, _ = L.attention_decode(bp["attn"], L.rmsnorm_apply(bp["ln1"], x), ck, cv, pos, cfg)
    x = x + a
    return x + _ffn(bp, x, cfg)


def _mla_block_decode(bp, x, latent, pos: int, cfg: ModelConfig):
    a, _ = MLA.mla_decode(bp["attn"], L.rmsnorm_apply(bp["ln1"], x), latent, pos, cfg)
    x = x + a
    return x + _ffn(bp, x, cfg)


def _ssm_block_decode(bp, x, state, conv, cfg: ModelConfig):
    y, _, _ = SSM.ssm_decode(bp["ssm"], L.rmsnorm_apply(bp["ln"], x), state, conv, cfg)
    return x + y


def _ssm_blocks(blocks, x, states, convs, cfg: ModelConfig):
    for i, bp in enumerate(layer_views(blocks)):
        x = _ssm_block_decode(bp, x, states[i], convs[i], cfg)
    return x


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------

def decode_step(params, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token step: batch = {"tokens": [B,1] int, "pos": host int}.

    Returns (logits [B, V_pad] fp32, cache), the cache updated in place.
    """
    pos = int(batch["pos"])
    x = L.embed_apply(params["embed"], batch["tokens"], cfg)

    if cfg.family == "ssm":
        x = _ssm_blocks(params["blocks"], x, cache["state"], cache["conv"], cfg)
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        for g, gp in enumerate(layer_views(params["groups"])):
            x = _ssm_blocks(gp, x, cache["g_state"][g], cache["g_conv"][g], cfg)
            x = _attn_block_decode(shared, x, cache["attn_k"][g], cache["attn_v"][g], pos, cfg)
        if "tail" in params:
            x = _ssm_blocks(params["tail"], x, cache["t_state"], cache["t_conv"], cfg)
    elif cfg.mla:
        if "dense_blocks" in params:
            for i, bp in enumerate(layer_views(params["dense_blocks"])):
                x = _mla_block_decode(bp, x, cache["dense_latent"][i], pos, cfg)
        for i, bp in enumerate(layer_views(params["blocks"])):
            x = _mla_block_decode(bp, x, cache["latent"][i], pos, cfg)
    else:
        if "dense_blocks" in params:
            for i, bp in enumerate(layer_views(params["dense_blocks"])):
                x = _attn_block_decode(bp, x, cache["dense_k"][i], cache["dense_v"][i], pos, cfg)
        for i, bp in enumerate(layer_views(params["blocks"])):
            x = _attn_block_decode(bp, x, cache["k"][i], cache["v"][i], pos, cfg)

    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.unembed_logits(_unembed_table(params, cfg), x[:, -1], cfg)
    return logits, cache


# --------------------------------------------------------------------------
# input specs (meta-tensor stand-ins for the dry run)
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract model inputs for one shape cell: meta tensors with the
    reference's shapes and dtypes (no allocation).  Decode's ``pos`` is a
    0-d int32, as in the reference; ``decode_step`` itself takes a host
    int there."""
    b, s = cell.global_batch, cell.seq_len
    cdt = cfg.compute_dtype

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "frames":
            out = {"frames": meta((b, s, FRAME_DIM), cdt)}
        elif cfg.frontend == "patch":
            n_img = cfg.frontend_tokens
            out = {"patches": meta((b, n_img, PATCH_DIM), cdt),
                   "tokens": meta((b, s - n_img), torch.int32)}
        else:
            out = {"tokens": meta((b, s), torch.int32)}
        if cell.kind == "train":
            out["labels"] = meta((b, s), torch.int32)
        return out

    # decode: one new token against a seq_len-deep cache
    return {"tokens": meta((b, 1), torch.int32), "pos": meta((), torch.int32)}
