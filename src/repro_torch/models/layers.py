"""Core transformer building blocks as (schema, apply) function pairs (port
of ``repro/models/layers.py``).

Every module exposes ``<name>_schema(cfg, ...) -> Schema`` and a plain
``<name>_apply(params, ...)`` on tensors; params are nested dicts of
tensors, stacked on a leading ``layers`` axis by the model, so that the
reference's parameter trees carry across one to one.

The order of operations is the reference's: norms, rotary angles, scores
and softmax in fp32; the projections as compute-dtype products with a
compute-dtype result.  Where the reference asks for fp32 accumulation and
an fp32 result of compute-dtype operands (``preferred_element_type``: the
unembedding and the attention scores), ``matmul_f32`` multiplies the
compute-dtype values in fp32: the products of two bf16 values are exact
in fp32, so only the order of the fp32 sum differs.  On the card this
needs TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``).

``constrain`` marks the activation sharding constraints at the reference's
call sites: inside ``with mesh:`` (``launch.mesh.Mesh``) it resolves the
reference's spec against that mesh, and outside one it returns at once.

Logical axes used here:
  embed (d_model) · heads · kv_heads · head_dim · mlp (d_ff) · vocab · layers
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as _mesh
from repro_torch.models.schema import P, ParamDef, Schema

# --------------------------------------------------------------------------
# activation sharding constraints
# --------------------------------------------------------------------------

def constraint_spec(names: tuple, axes: tuple) -> P:
    """The spec of ``constrain(x, *axes)`` on a mesh with axis ``names``:
    'batch' -> ('pod', 'data') (whichever exist), 'model' -> the model
    axis, anything else replicated."""
    resolved = []
    for a in axes:
        if a == "batch":
            ba = tuple(n for n in ("pod", "data") if n in names)
            resolved.append(ba if ba else None)
        elif a == "model":
            resolved.append("model" if "model" in names else None)
        else:
            resolved.append(None)
    return P(*resolved)


def _place(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``x`` laid out as ``spec``: on one card there is nothing to move."""
    return x


def constrain(x: torch.Tensor, *axes: "str | None") -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh, by convention: 'batch' -> ('pod','data') (whichever exist),
    'model' -> model axis.  Returns ``x`` itself; outside a mesh it does
    nothing else (one check, no allocation, no host read)."""
    mesh = _mesh.ambient
    if mesh is None:
        return x
    return _place(x, constraint_spec(mesh.axis_names, axes))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm_schema(dim: int) -> Schema:
    return {"scale": ParamDef((dim,), ("embed",), init="ones")}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  The
    half-split rotation (first half against second half, not interleaved)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def embed_schema(cfg: ModelConfig) -> Schema:
    return {
        "table": ParamDef(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
            dtype=cfg.param_dtype, init="embed",
        )
    }


def embed_apply(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather the rows, then cast: bitwise the reference's cast-then-gather,
    # without casting the whole table
    return params["table"][tokens].to(cfg.compute_dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of compute-dtype operands, accumulated and returned in
    fp32 (the reference's ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(a.float(), b.float())


def unembed_logits(table: torch.Tensor, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h: [..., d] -> logits [..., V_pad] (compute-dtype operands, fp32
    accumulation and result)."""
    cdt = cfg.compute_dtype
    return matmul_f32(h.to(cdt), table.to(cdt).T)


def _ce_chunk(table: torch.Tensor, h: torch.Tensor, lab: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed CE, counted labels) of one sequence chunk h [b, chunk, d]."""
    h = constrain(h, "batch", None, None)
    logits = unembed_logits(table, h, cfg)  # [b, chunk, V_pad] fp32
    # keep batch sharded and vocab model-sharded through the CE math
    logits = constrain(logits, "batch", None, "model")
    # mask padded vocab entries out of the partition function
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    w = (lab >= 0).float()  # negative labels = ignore (VLM)
    # the gold logit by a gather: on one card exactly the reference's
    # one-hot contraction (one nonzero term), without its [b, chunk, V] one-hot
    gold = torch.gather(logits, -1, torch.clamp(lab, min=0).long()[..., None])[..., 0]
    return torch.sum(w * (lse - gold)), torch.sum(w)


def chunked_ce_loss(
    table: torch.Tensor,
    hidden: torch.Tensor,
    labels: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Cross-entropy without materializing [B, S, V] logits.

    Walks sequence chunks of ``loss_chunk``; while gradients are recorded
    each chunk runs under a non-reentrant ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` on its chunk), so its logits are
    recomputed in the backward pass and peak memory is one
    [B, chunk, V_pad] fp32 buffer instead of the full logits tensor.
    """
    s = hidden.shape[1]
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss_chunk {chunk} != 0")
    hidden = constrain(hidden, "batch", None, None)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        args = (table, hidden[:, i:i + chunk], labels[:, i:i + chunk], cfg)
        if torch.is_grad_enabled():
            loss, cnt = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            loss, cnt = _ce_chunk(*args)
        total, count = total + loss, count + cnt
    return total / torch.clamp(count, min=1.0)


# --------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain)
# --------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> Schema:
    d_ff = d_ff or cfg.d_ff
    pdt = cfg.param_dtype
    sch: Schema = {
        "w_up": ParamDef((cfg.d_model, d_ff), ("embed", "mlp"), dtype=pdt),
        "w_down": ParamDef((d_ff, cfg.d_model), ("mlp", "embed"), dtype=pdt),
    }
    if cfg.gated_mlp:
        sch["w_gate"] = ParamDef((cfg.d_model, d_ff), ("embed", "mlp"), dtype=pdt)
    return sch


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    xc = x.to(cdt)
    up = torch.matmul(xc, params["w_up"].to(cdt))
    if cfg.gated_mlp:
        gate = torch.matmul(xc, params["w_gate"].to(cdt))
        h = _act(gate, cfg.mlp_act) * up
    else:
        h = _act(up, cfg.mlp_act)
    return torch.matmul(h, params["w_down"].to(cdt))


# --------------------------------------------------------------------------
# GQA attention (full / sliding-window / bidirectional; prefill + decode)
# --------------------------------------------------------------------------

def attention_schema(cfg: ModelConfig) -> Schema:
    hd = cfg.head_dim_eff
    pdt = cfg.param_dtype
    sch: Schema = {
        "wq": ParamDef((cfg.d_model, cfg.num_heads, hd), ("embed", "heads", "head_dim"), dtype=pdt),
        "wk": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim"), dtype=pdt),
        "wv": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim"), dtype=pdt),
        "wo": ParamDef((cfg.num_heads, hd, cfg.d_model), ("heads", "head_dim", "embed"), dtype=pdt),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamDef((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros", dtype=pdt)
        sch["bk"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros", dtype=pdt)
        sch["bv"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros", dtype=pdt)
    return sch


def _proj(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``...sd,dhk->...shk``: x [..., S, d] by w [d, H, K]."""
    d, h, k = w.shape
    return torch.matmul(xc, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    cdt = cfg.compute_dtype
    xc = x.to(cdt)
    q = _proj(xc, params["wq"].to(cdt))
    k = _proj(xc, params["wk"].to(cdt))
    v = _proj(xc, params["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    if cfg.use_rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(
    q: torch.Tensor,        # [B, Sq, H, D]
    k: torch.Tensor,        # [B, Skv, K, D]
    v: torch.Tensor,        # [B, Skv, K, D]
    *,
    causal: bool,
    q_positions: torch.Tensor,   # [Sq] absolute positions of queries
    kv_positions: torch.Tensor,  # [Skv]
    window: int = 0,
    kv_len: Optional[int] = None,  # mask kv positions >= kv_len (decode)
) -> torch.Tensor:
    """Grouped-query attention core with fp32 scores and softmax: the
    scores divided by sqrt(D) after the product, masked to -1e30, the
    softmax in fp32, the probabilities cast to ``q``'s dtype before the
    product with ``v``."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    # the G query heads of a KV head as rows of one product: [B, K, G*Sq, D]
    qg = q.reshape(b, sq, kheads, g, d).permute(0, 2, 3, 1, 4).reshape(b, kheads, g * sq, d)
    scores = matmul_f32(qg, k.permute(0, 2, 3, 1)) / math.sqrt(d)  # [B, K, G*Sq, Skv]
    scores = scores.unflatten(2, (g, sq))                            # [B, K, G, Sq, Skv]
    qpos = q_positions[:, None]   # [Sq, 1]
    kpos = kv_positions[None, :]  # [1, Skv]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).flatten(2, 3)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3))  # [B, K, G*Sq, D]
    return out.unflatten(2, (g, sq)).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``...shk,hkd->...sd``: out [..., S, H, K] by wo [H, K, d]."""
    h, k, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.reshape(h * k, d))


def attention_apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Full-sequence (train/prefill) attention."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = gqa_attend(
        q, k, v,
        causal=cfg.causal,
        q_positions=positions,
        kv_positions=positions,
        window=cfg.attn_window,
    )
    return _out_proj(out, params["wo"].to(cfg.compute_dtype))


def attention_decode(
    params,
    x: torch.Tensor,            # [B, 1, d]
    cache_k: torch.Tensor,      # [B, T, K, D]
    cache_v: torch.Tensor,
    pos: int,                   # current position (tokens so far), a host int
    cfg: ModelConfig,
):
    """One-token decode against a KV cache; writes the new key and value
    into ``cache_k`` / ``cache_v`` in place and returns (y, cache_k, cache_v).

    With a sliding window the cache is a ring buffer of size ``window`` and
    slot = pos % window; otherwise slot = pos.  The step attends over the
    whole cache length T with a ``kv_len = pos + 1`` mask, as the reference
    does.
    """
    t = cache_k.shape[1]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    slot = pos % t if cfg.attn_window > 0 else pos
    slot = min(slot, t - 1)  # dynamic_update_slice clamps its start index
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    idx = torch.arange(t, dtype=torch.int32, device=x.device)
    if cfg.attn_window > 0:
        # ring buffer: absolute position of each slot given current pos.
        # Slots beyond pos%t hold the *previous* cycle (base - t + idx);
        # slots never written yet get a sentinel past `pos` so the causal
        # mask excludes them.
        cur = pos % t
        base = pos - cur
        abs_pos = torch.where(idx <= cur, base + idx, base - t + idx)
        kv_positions = torch.where(abs_pos >= 0, abs_pos, 2**30)
        out = gqa_attend(
            q, cache_k.to(q.dtype), cache_v.to(q.dtype),
            causal=True, q_positions=positions, kv_positions=kv_positions,
            window=cfg.attn_window,
        )
    else:
        out = gqa_attend(
            q, cache_k.to(q.dtype), cache_v.to(q.dtype),
            causal=True, q_positions=positions, kv_positions=idx,
            kv_len=pos + 1,
        )
    y = _out_proj(out, params["wo"].to(cfg.compute_dtype))
    return y, cache_k, cache_v
