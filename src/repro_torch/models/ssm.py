"""Mamba2 (SSD — state-space duality) block, chunked matmul formulation
(port of ``repro/models/ssm.py``).

The SSD algorithm in its block-decomposition form: intra-chunk quadratic
attention-like products plus an inter-chunk linear state recurrence, one
short loop over chunks (the reference's ``lax.scan``; its body is a product
and an add on ``[B, H, P, N]`` states, not a scalar recursion).  Chunk
length is a config knob (default 256).

Decode keeps O(1) state: an fp32 ``[B, H, P, N]`` SSM state plus a
``[B, d_conv-1, conv_dim]`` causal-conv window, both updated in place.

``A_log``, ``D`` and ``dt_bias`` are fp32 parameters and the gated ``norm``
is read in fp32, as in the reference; ``D`` is cast to the compute dtype
in ``ssm_apply`` but used in fp32 in ``ssm_decode``, as there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import constrain, matmul_f32
from repro_torch.models.schema import ParamDef, Schema


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return d_inner, nheads, conv_dim


def ssm_schema(cfg: ModelConfig) -> Schema:
    s = cfg.ssm
    pdt = cfg.param_dtype
    d_inner, nheads, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * s.ngroups * s.d_state + nheads  # z, x, B, C, dt
    return {
        "in_proj": ParamDef((cfg.d_model, in_dim), ("embed", "ssm_inner"), dtype=pdt),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "ssm_inner"), dtype=pdt, init="normal:0.1"),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), dtype=pdt, init="zeros"),
        "A_log": ParamDef((nheads,), (None,), dtype=torch.float32, init="zeros"),
        "D": ParamDef((nheads,), (None,), dtype=torch.float32, init="ones"),
        "dt_bias": ParamDef((nheads,), (None,), dtype=torch.float32, init="zeros"),
        "norm": ParamDef((d_inner,), ("ssm_inner",), init="ones", dtype=pdt),
        "out_proj": ParamDef((d_inner, cfg.d_model), ("ssm_inner", "embed"), dtype=pdt),
    }


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xBC, dt


def _gated_norm(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)) — Mamba2's gated output norm."""
    dt = y.dtype
    yf = (y * F.silu(z)).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * params["norm"].float()).to(dt)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < l <= i} a[..., l].

    a: [..., L] -> [..., L, L] lower-triangular cumulative log-decays.
    """
    n = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    idx = torch.arange(n, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,     # [B, S, H, P]   (pre-scaled by dt)
    a: torch.Tensor,     # [B, S, H]      log-decay per step (dt * A, negative)
    B: torch.Tensor,     # [B, S, G, N]
    C: torch.Tensor,     # [B, S, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD block decomposition.  Returns (y [B,S,H,P] in x's dtype,
    final_state [B,H,P,N] fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")
    nc = s // chunk
    rep = h // g  # broadcast groups to heads

    xf = x.reshape(b, nc, chunk, h, p).float()
    ac = a.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # [b,nc,l,h,n]
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    # ---- intra-chunk (quadratic, attention-like) ----
    Lm = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))                    # [b,nc,h,l,l]
    scores = matmul_f32(Cc.permute(0, 1, 3, 2, 4), Bc.permute(0, 1, 3, 4, 2))  # bchls
    y_diag = torch.matmul(scores * Lm, xf.permute(0, 1, 3, 2, 4))      # [b,nc,h,l,p]

    # ---- chunk states ----
    cum = torch.cumsum(ac, dim=2)                                      # [b,nc,l,h]
    last = cum[:, :, -1:, :]                                           # [b,nc,1,h]
    decay_to_end = torch.exp(last - cum)                               # [b,nc,l,h]
    states = torch.matmul((xf * decay_to_end[..., None]).permute(0, 1, 3, 4, 2),
                          Bc.float().permute(0, 1, 3, 2, 4))           # [b,nc,h,p,n]

    # ---- inter-chunk recurrence (linear, over nc chunks) ----
    chunk_decay = torch.exp(last[:, :, 0, :])                          # [b,nc,h]
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state *entering* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                             # [b,nc,h,p,n]

    # ---- inter-chunk output ----
    cw = (Cc.float() * torch.exp(cum)[..., None]).permute(0, 1, 3, 2, 4)   # [b,nc,h,l,n]
    y_off = torch.matmul(cw, prev_states.transpose(-1, -2))            # [b,nc,h,l,p]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def _conv_split(xBC: torch.Tensor, cfg: ModelConfig):
    """The conv output's x [.., H, P], B and C [.., G, N] parts."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    lead = xBC.shape[:-1]
    xh = xBC[..., :d_inner].reshape(*lead, nheads, s.headdim)
    Bm = xBC[..., d_inner:d_inner + gn].reshape(*lead, s.ngroups, s.d_state)
    Cm = xBC[..., d_inner + gn:].reshape(*lead, s.ngroups, s.d_state)
    return xh, Bm, Cm


def ssm_apply(params, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block (train/prefill)."""
    s = cfg.ssm
    cdt = cfg.compute_dtype
    d_inner, _, _ = _dims(cfg)
    zxbcdt = torch.matmul(xin.to(cdt), params["in_proj"].to(cdt))
    # keep the wide inner activation model-sharded through conv/SSD
    if cfg.ssm_shard_constraints:
        zxbcdt = constrain(zxbcdt, "batch", None, "model")
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)

    # causal depthwise conv over the sequence (width d_conv), summed in the
    # reference's order
    sl = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, s.d_conv - 1, 0))
    conv = sum(pad[:, i:i + sl, :] * params["conv_w"][i].to(cdt)
               for i in range(s.d_conv)) + params["conv_b"].to(cdt)
    xh, Bm, Cm = _conv_split(F.silu(conv), cfg)
    dt = F.softplus(dt.float() + params["dt_bias"])                    # [b,s,h]
    A = -torch.exp(params["A_log"])                                    # [h]
    y, _ = ssd_chunked(xh * dt[..., None].to(cdt), dt * A, Bm, Cm, s.chunk)
    y = y + params["D"].to(cdt)[None, None, :, None] * xh
    y = y.reshape(xh.shape[0], sl, d_inner)
    if cfg.ssm_shard_constraints:
        y = constrain(y, "batch", None, "model")
    y = _gated_norm(params, y, z)
    return torch.matmul(y, params["out_proj"].to(cdt))


def ssm_decode(
    params,
    xin: torch.Tensor,         # [B, 1, d]
    ssm_state: torch.Tensor,   # [B, H, P, N] fp32
    conv_state: torch.Tensor,  # [B, d_conv-1, conv_dim]
    cfg: ModelConfig,
):
    """One-token recurrent update; updates both states in place and returns
    (y, ssm_state, conv_state)."""
    s = cfg.ssm
    cdt = cfg.compute_dtype
    d_inner, nheads, _ = _dims(cfg)
    zxbcdt = torch.matmul(xin.to(cdt), params["in_proj"].to(cdt))
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)                            # [B,1,*]
    window = torch.cat([conv_state.to(cdt), xBC], dim=1)               # [B,d_conv,conv_dim]
    conv = torch.einsum("btc,tc->bc", window, params["conv_w"].to(cdt)) + params[
        "conv_b"].to(cdt)
    conv_state.copy_(window[:, 1:, :])
    xh, Bv, Cv = _conv_split(F.silu(conv), cfg)                        # [B,H,P], [B,G,N]
    rep = nheads // s.ngroups
    Bh = Bv.repeat_interleave(rep, dim=1).float()                      # [B,H,N]
    Ch = Cv.repeat_interleave(rep, dim=1).float()
    xh = xh.float()
    dt1 = F.softplus(dt[:, 0, :].float() + params["dt_bias"])          # [B,H]
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt1 * A)                                         # [B,H]
    upd = (xh * dt1[..., None])[..., None] * Bh[:, :, None, :]         # bhn,bhp->bhpn
    ssm_state.mul_(decay[..., None, None]).add_(upd)
    y = torch.matmul(ssm_state, Ch[..., None])[..., 0]                 # bhn,bhpn->bhp
    y = y + params["D"][None, :, None] * xh
    y = _gated_norm(params, y.reshape(-1, 1, d_inner).to(cdt), z)
    return torch.matmul(y, params["out_proj"].to(cdt)), ssm_state, conv_state
