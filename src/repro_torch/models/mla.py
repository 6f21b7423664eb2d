"""Multi-head Latent Attention (DeepSeek-V2) (port of ``repro/models/mla.py``).

V2-Lite layout: queries are uncompressed; keys/values are generated from a
shared low-rank latent ``c_kv`` (kv_lora_rank) plus a single shared rotary
key ``k_pe``.  The decode path uses the *absorbed* formulation — W_uk folds
into the query and W_uv into the output — so the cache holds only
``[B, T, kv_lora + rope]`` per layer and decode attention runs entirely in
latent space, with no per-head K/V expansion.

As in ``layers``, the scores are products of compute-dtype values
accumulated and returned in fp32 (``layers.matmul_f32``), the latent's
norm and the softmax in fp32.  The latent products of a decode step treat
the S * H query rows of a sequence as the rows of one product against its
``[T, r]`` latent, so the latent is never broadcast over the heads.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _out_proj, _proj, matmul_f32, rope_apply
from repro_torch.models.schema import ParamDef, Schema


def mla_schema(cfg: ModelConfig) -> Schema:
    m = cfg.mla
    pdt = cfg.param_dtype
    h = cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamDef((cfg.d_model, h, qd), ("embed", "heads", "head_dim"), dtype=pdt),
        # down-projection to the compressed latent + the shared rope key
        "w_dkv": ParamDef(
            (cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim),
            ("embed", None), dtype=pdt,
        ),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones", dtype=pdt),
        "w_uk": ParamDef(
            (m.kv_lora_rank, h, m.qk_nope_head_dim), (None, "heads", "head_dim"), dtype=pdt
        ),
        "w_uv": ParamDef(
            (m.kv_lora_rank, h, m.v_head_dim), (None, "heads", "head_dim"), dtype=pdt
        ),
        "wo": ParamDef((h, m.v_head_dim, cfg.d_model), ("heads", "head_dim", "embed"), dtype=pdt),
    }


def _latent(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Project to (normalized) kv latent + rope'd shared key."""
    m = cfg.mla
    cdt = cfg.compute_dtype
    dkv = torch.matmul(x.to(cdt), params["w_dkv"].to(cdt))
    c_kv, k_pe = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    # rmsnorm on the latent (deepseek applies a norm before up-projection)
    cf = c_kv.float()
    c_kv = (cf * torch.rsqrt(torch.mean(cf * cf, -1, keepdim=True) + 1e-6)
            * params["kv_norm"].float()).to(cdt)
    k_pe = rope_apply(k_pe[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_pe


def _queries(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    m = cfg.mla
    cdt = cfg.compute_dtype
    q = _proj(x.to(cdt), params["wq"].to(cdt))
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = rope_apply(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def _rows_by_shared(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """``bshk,btk->bhst`` in fp32: the S * H query rows [B, S, H, K] of each
    sequence against its shared keys [B, T, K]."""
    b, s, h, k = q.shape
    out = matmul_f32(q.reshape(b, s * h, k), kv.transpose(1, 2))   # [B, S*H, T]
    return out.reshape(b, s, h, -1).permute(0, 2, 1, 3)


def mla_apply(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (train/prefill): expand K/V per head."""
    cdt = cfg.compute_dtype
    c_kv, k_pe = _latent(params, x, cfg, positions)
    q_nope, q_pe = _queries(params, x, cfg, positions)
    k_nope = _proj(c_kv, params["w_uk"].to(cdt))   # ...tr,rhk->...thk
    v = _proj(c_kv, params["w_uv"].to(cdt))
    scores = (matmul_f32(q_nope.transpose(1, 2), k_nope.permute(0, 2, 3, 1))
              + _rows_by_shared(q_pe, k_pe)) * _scale(cfg)          # [B, H, S, T]
    s, t = scores.shape[-2], scores.shape[-1]
    mask = (torch.arange(t, device=x.device)[None, :]
            <= torch.arange(s, device=x.device)[:, None])
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    ctx = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)      # [B, S, H, K]
    return _out_proj(ctx, params["wo"].to(cdt))


def mla_decode(
    params,
    x: torch.Tensor,          # [B, 1, d]
    cache: torch.Tensor,      # [B, T, kv_lora + rope]  (latent cache)
    pos: int,                 # current position, a host int
    cfg: ModelConfig,
):
    """Absorbed one-token decode: scores and context in latent space.
    Writes the new latent entry into ``cache`` in place (at ``pos``,
    clamped to the last row as ``dynamic_update_slice`` clamps) and returns
    (y, cache)."""
    m = cfg.mla
    cdt = cfg.compute_dtype
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_kv, k_pe = _latent(params, x, cfg, positions)
    t = cache.shape[1]
    slot = min(pos, t - 1)
    cache[:, slot:slot + 1] = torch.cat([c_kv, k_pe], dim=-1).to(cache.dtype)
    lat = cache[..., :m.kv_lora_rank].to(cdt)      # [B,T,r]
    pe = cache[..., m.kv_lora_rank:].to(cdt)       # [B,T,p]
    q_nope, q_pe = _queries(params, x, cfg, positions)
    # absorb W_uk into the query: q_lat[b,s,h,r] = q_nope . W_uk
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(cdt))
    scores = (_rows_by_shared(q_lat, lat) + _rows_by_shared(q_pe, pe)) * _scale(cfg)
    valid = torch.arange(t, device=x.device) < pos + 1
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cdt)                    # [B, H, S, T]
    b, h, s, _ = probs.shape
    # latent-space context: bhst,btr->bshr
    ctx_lat = torch.matmul(probs.transpose(1, 2).reshape(b, s * h, t), lat).reshape(b, s, h, -1)
    # absorb W_uv on the way out
    ctx = torch.einsum("bshr,rhk->bshk", ctx_lat, params["w_uv"].to(cdt))
    return _out_proj(ctx, params["wo"].to(cdt)), cache
