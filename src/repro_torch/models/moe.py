"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): GShard-style
grouped dense dispatch, and the sort dispatch it is held against.

Tokens are split into groups of ``group_size``; capacity is per group
(C = ceil(group * top_k * capacity_factor / E)).  Routing is expressed as
capacity-bounded one-hot dispatch / combine products, so the whole layer is
dense matmuls with no host read: the einsum dispatch computes every
expert's C slots, whichever tokens they hold.

Supports:
  * top-k routing with renormalized softmax gates,
  * shared (always-on) experts (DeepSeek-V2),
  * a parallel dense FFN residual branch (Arctic),
  * switch-style load-balancing auxiliary loss.

The top k is taken from a stable descending sort, so equal probabilities
pick the lower expert index first, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order among ties).  The per-expert products are
one batched product over the expert axis ``[E, G * C, d] @ [E, d, f]``,
which never copies an expert's weights.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, constrain, matmul_f32, mlp_apply, mlp_schema
from repro_torch.models.schema import ParamDef, Schema

AUX_LOSS_COEF = 0.01


def moe_schema(cfg: ModelConfig) -> Schema:
    m = cfg.moe
    pdt = cfg.param_dtype
    e, d, f = m.num_experts, cfg.d_model, m.expert_d_ff
    sch: Schema = {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32, init="normal:0.02"),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "mlp"), dtype=pdt),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "mlp"), dtype=pdt),
        "w_down": ParamDef((e, f, d), ("experts", "mlp", "embed"), dtype=pdt),
    }
    if m.shared_experts:
        sch["shared"] = mlp_schema(cfg, d_ff=m.shared_experts * m.expert_d_ff)
    if m.dense_parallel:
        sch["dense"] = mlp_schema(cfg, d_ff=cfg.d_ff)
    return sch


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  Dispatch per cfg.moe.dispatch."""
    if cfg.moe.dispatch == "sort":
        return moe_apply_sorted(params, x, cfg)
    return _moe_apply_einsum(params, x, cfg)


def _groups(x: torch.Tensor, cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups, group size, capacity) for x's B * S tokens."""
    m = cfg.moe
    tokens = x.shape[0] * x.shape[1]
    gs = min(m.group_size, tokens)
    if tokens % gs:
        raise ValueError(f"tokens {tokens} % group_size {gs}")
    cap = max(1, math.ceil(gs * m.top_k * m.capacity_factor / m.num_experts))
    return tokens // gs, gs, cap


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot over a last axis of n (a comparison: no host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(params, xg: torch.Tensor, cfg: ModelConfig):
    """Router of grouped tokens xg [g, t, d] (compute dtype): (probs
    [g, t, E] fp32, renormalized gates [g, t, k], expert indices [g, t, k]),
    the top k by a stable descending sort (ties to the lower index)."""
    logits = matmul_f32(xg, params["router"].to(xg.dtype))
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :cfg.moe.top_k], idx[..., :cfg.moe.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _experts(params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP of each expert over its slots: xe [g, E, C, d] ->
    [g, E, C, d], as one product batched over the expert axis."""
    cdt = cfg.compute_dtype
    g, e, c, d = xe.shape
    xs = xe.transpose(0, 1).reshape(e, g * c, d)
    hg = torch.matmul(xs, params["w_gate"].to(cdt))
    hu = torch.matmul(xs, params["w_up"].to(cdt))
    ye = torch.matmul(_act(hg, cfg.mlp_act) * hu, params["w_down"].to(cdt))
    return ye.reshape(e, g, c, d).transpose(0, 1)


def _aux_and_branches(params, x, y, probs, idx, cfg: ModelConfig):
    """The load-balancing loss, then the shared and dense branches."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    me = probs.mean(dim=(0, 1))                              # mean router prob
    ce = _one_hot(idx, e).sum(2).mean(dim=(0, 1)) / k        # dispatch fraction
    aux = AUX_LOSS_COEF * e * torch.sum(me * ce)             # == coef at uniform
    if m.shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg)
    if m.dense_parallel:
        y = y + mlp_apply(params["dense"], x, cfg)
    return y.to(x.dtype), aux


def _moe_apply_einsum(params, x: torch.Tensor, cfg: ModelConfig):
    """GShard-style dense one-hot dispatch (the configs' default)."""
    m = cfg.moe
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    g, gs, cap = _groups(x, cfg)
    e, k = m.num_experts, m.top_k

    xg = x.reshape(g, gs, d).to(cdt)
    probs, gate, idx = route(params, xg, cfg)

    # -- capacity assignment over the flattened (token-major, then k) order --
    onehot = _one_hot(idx, e)                                # [g,t,k,e]
    flat = constrain(onehot.reshape(g, gs * k, e), "batch", None, None)
    pos = torch.cumsum(flat, dim=1) - flat                   # slots used before
    keep = (pos < cap) * flat                                # [g,t*k,e]
    slot_oh = _one_hot(torch.clamp(pos, max=cap - 1).to(torch.int32), cap)
    dispatch_flat = keep[..., None] * slot_oh                # [g,t*k,e,cap]
    combine_flat = dispatch_flat * gate.reshape(g, gs * k)[..., None, None]
    dispatch = dispatch_flat.reshape(g, gs, k, e, cap).sum(2).to(cdt)
    combine = combine_flat.reshape(g, gs, k, e, cap).sum(2).to(cdt)

    # -- expert computation: gtec,gtd->gecd; the experts; gtec,gecd->gtd --
    xe = torch.matmul(dispatch.reshape(g, gs, e * cap).transpose(1, 2), xg)
    ye = _experts(params, xe.reshape(g, e, cap, d), cfg)
    y = torch.matmul(combine.reshape(g, gs, e * cap), ye.reshape(g, e * cap, d))
    return _aux_and_branches(params, x, y.reshape(b, s, d), probs, idx, cfg)


def moe_apply_sorted(params, x: torch.Tensor, cfg: ModelConfig):
    """Sort-based dispatch: a stable sort of the token-expert assignments,
    the tokens gathered into per-expert capacity slots, the expert FF, and
    a scatter-add back.  The same drop semantics as the einsum path
    (token-major priority within each group, capacity C per expert per
    group).

    The reference's three ``mode="drop"`` scatters land here as the
    reference sizes them: the segment starts' index is always an expert,
    and the buffer and the combine each carry a dump row (slot E * C,
    token gs) that takes the dropped assignments and is sliced off.  The
    combine's scatter-add over a token's k targets sums in an order the
    reference does not fix (float: within tolerance, not bitwise)."""
    m = cfg.moe
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    g, gs, cap = _groups(x, cfg)
    e, k = m.num_experts, m.top_k

    xg = x.reshape(g, gs, d).to(cdt)
    probs, gate, idx = route(params, xg, cfg)

    # flatten (token-major, then k) to match the einsum path's priority;
    # the stable sort keeps token order within each expert segment
    e_flat = idx.reshape(g, gs * k)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    ar = torch.arange(gs * k, device=x.device).expand(g, gs * k)
    seg_start = torch.full((g, e), gs * k, dtype=ar.dtype, device=x.device).scatter_reduce(
        1, e_sorted, ar, reduce="amin", include_self=True)
    pos = ar - torch.gather(seg_start, 1, e_sorted)
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos, e * cap)    # e * cap: the dump slot

    token_of = order // k                                       # source token
    # gather tokens into [g, e*cap, d] buffers (+1 dump slot for drops)
    buf_tok = torch.full((g, e * cap + 1), gs, dtype=order.dtype, device=x.device)
    buf_tok = buf_tok.scatter(1, slot, torch.where(keep, token_of, gs))[:, :e * cap]
    xg_pad = torch.cat([xg, torch.zeros((g, 1, d), dtype=cdt, device=x.device)], dim=1)
    xe = torch.gather(xg_pad, 1, buf_tok[..., None].expand(g, e * cap, d))
    ye = _experts(params, xe.reshape(g, e, cap, d), cfg).reshape(g, e * cap, d)

    # combine: gather each kept assignment's expert output, gate, scatter-add
    gate_flat = torch.gather(gate.reshape(g, gs * k), 1, order)
    w_slot = torch.where(keep, gate_flat, 0.0).to(cdt)
    vals = torch.gather(ye, 1, torch.clamp(slot, max=e * cap - 1)[..., None].expand(
        g, gs * k, d)) * w_slot[..., None]
    tgt = torch.where(keep, token_of, gs)                       # gs: the dump row
    y = torch.zeros((g, gs + 1, d), dtype=cdt, device=x.device).scatter_add(
        1, tgt[..., None].expand(g, gs * k, d), vals)[:, :gs]
    return _aux_and_branches(params, x, y.reshape(b, s, d), probs, idx, cfg)
