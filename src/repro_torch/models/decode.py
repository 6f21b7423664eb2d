"""Autoregressive decode (port of ``repro/models/decode.py`` for the
attention families): the KV cache and the one-token step.

Cache shapes (leading L = stacked layer axis):

  attention (dense/vlm/audio): k,v  [L, B, T, KV, D]  in the cache dtype

T = min(seq_len, attn_window): sliding-window archs keep a ring buffer.
The MLA latent, SSM state and hybrid caches raise ``NotImplementedError``
(ROADMAP item 15b); ``input_specs`` (the dry run's inputs) waits for item
15e.

The step takes its position as a host ``int`` so that it reads nothing
back from the card, and writes the new keys and values into the cache in
place (the reference donates the cache to its jitted step, so the two
agree), returning the same cache with the logits.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import _unembed_table, layer_views, require_attention_family


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.attn_window) if cfg.attn_window else seq_len


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The cache's shapes and dtypes, ``{name: (shape, dtype)}``, with no
    allocation.  KV caches use ``cfg.cache_dtype`` (default the compute
    dtype)."""
    require_attention_family(cfg, "the decode cache")
    t = cache_len(cfg, seq_len)
    cdt = cfg.cache_dtype or cfg.compute_dtype
    shape = (cfg.num_layers, batch, t, cfg.num_kv_heads, cfg.head_dim_eff)
    return {"k": (shape, cdt), "v": (shape, cdt)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in cache_spec(cfg, batch, seq_len).items()}


def _attn_block_decode(bp, x, ck, cv, pos: int, cfg: ModelConfig):
    a, nck, ncv = L.attention_decode(
        bp["attn"], L.rmsnorm_apply(bp["ln1"], x), ck, cv, pos, cfg
    )
    x = x + a
    y = L.mlp_apply(bp["ffn"], L.rmsnorm_apply(bp["ln2"], x), cfg)
    return x + y, nck, ncv


def decode_step(params, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token step: batch = {"tokens": [B,1] int, "pos": host int}.

    Returns (logits [B, V_pad] fp32, cache), the cache updated in place.
    """
    require_attention_family(cfg, "the decode step")
    pos = int(batch["pos"])
    x = L.embed_apply(params["embed"], batch["tokens"], cfg)
    for i, bp in enumerate(layer_views(params["blocks"])):
        x, _, _ = _attn_block_decode(bp, x, cache["k"][i], cache["v"][i], pos, cfg)
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.unembed_logits(_unembed_table(params, cfg), x[:, -1], cfg)
    return logits, cache
