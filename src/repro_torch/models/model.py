"""Model assembly (port of ``repro/models/model.py``): schema, forward and
last-position logits for every family.

One generic stack covers all 10 architectures:

  dense   — pre-norm GQA attention + (SwiGLU|GeGLU) MLP
  moe     — attention + MoE FFN (optional leading dense layers, shared
            experts, parallel dense branch)
  mla     — DeepSeek MLA attention replaces GQA
  ssm     — Mamba2 SSD blocks, attention-free
  hybrid  — Zamba2: groups of SSD blocks + one *shared-weight* attention
            block applied after each group
  audio   — HuBERT-style encoder-only (bidirectional, frame-embedding stub)
  vlm     — LLaVA-style: projected patch embeddings prepended to the token
            stream, causal LM on top

Layers are stacked on a leading "layers" axis, as in the reference, so its
parameter trees carry across one to one (``schema.params_from_numpy``).
``_scan_blocks`` walks them with a Python loop over per-layer views
(``layer_views``) in place of ``lax.scan``: that loop stands for both
values of ``scan_layers`` (``lax.scan`` and the reference's unrolled loop
compute the same thing), for the blocks, DeepSeek's leading dense blocks,
the hybrid's groups and its tail alike.  Each block body goes through
``_maybe_remat`` where the reference's does: with ``cfg.remat`` and while
gradients are recorded it runs under a non-reentrant
``torch.utils.checkpoint`` (``remat_policy`` "full": recompute the whole
body in the backward pass; "dots": keep the outputs of the products
without batch dims, ``aten.mm`` / ``aten.addmm``, and recompute the rest,
the counterpart of ``dots_with_no_batch_dims_saveable``).  Under
``torch.no_grad`` or ``inference_mode`` (serving, decode) no checkpoint is
taken.  ``loss_fn`` is the chunked cross-entropy plus the MoE aux loss.

``LanguageModel`` is the ``nn.Module`` face of the same functions: it holds
the parameter tree and serves ``forward``, ``logits_last`` and
``decode_step``; ``tree()`` hands out the parameters themselves, which
require no gradient until a trainer calls ``requires_grad_(True)``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.schema import (
    ParamDef,
    Schema,
    init_params,
    map_schema,
    map_tree,
    param_count,
    tree_leaves,
)

PATCH_DIM = 1024   # vision-tower stub output dim (CLIP-L/14-like)
FRAME_DIM = 512    # audio conv-frontend stub output dim


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def stack_schema(n: int, sch: Schema) -> Schema:
    return map_schema(
        sch, lambda pd: ParamDef((n,) + pd.shape, ("layers",) + pd.axes,
                                 dtype=pd.dtype, init=pd.init,
                                 fan_axis=pd.fan_axis + 1),
    )


def _attn_block_schema(cfg: ModelConfig) -> Schema:
    attn = MLA.mla_schema(cfg) if cfg.mla else L.attention_schema(cfg)
    return {"ln1": L.rmsnorm_schema(cfg.d_model), "attn": attn,
            "ln2": L.rmsnorm_schema(cfg.d_model),
            "ffn": MOE.moe_schema(cfg) if cfg.moe else L.mlp_schema(cfg)}


def _dense_block_schema(cfg: ModelConfig) -> Schema:
    """Plain dense block (used for DeepSeek's leading non-MoE layers)."""
    attn = MLA.mla_schema(cfg) if cfg.mla else L.attention_schema(cfg)
    return {"ln1": L.rmsnorm_schema(cfg.d_model), "attn": attn,
            "ln2": L.rmsnorm_schema(cfg.d_model),
            "ffn": L.mlp_schema(cfg, d_ff=cfg.d_ff or cfg.moe.expert_d_ff)}


def _ssm_block_schema(cfg: ModelConfig) -> Schema:
    return {"ln": L.rmsnorm_schema(cfg.d_model), "ssm": SSM.ssm_schema(cfg)}


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, layers_per_group, tail) for hybrid archs."""
    per = cfg.attn_every
    groups = cfg.num_layers // per
    tail = cfg.num_layers - groups * per
    return groups, per, tail


def model_schema(cfg: ModelConfig) -> Schema:
    sch: Schema = {"embed": L.embed_schema(cfg),
                   "final_norm": L.rmsnorm_schema(cfg.d_model)}
    if not cfg.tie_embeddings:
        sch["lm_head"] = {
            "table": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                              dtype=cfg.param_dtype, init="embed")
        }
    if cfg.frontend == "patch":
        sch["frontend_proj"] = {
            "w": ParamDef((PATCH_DIM, cfg.d_model), (None, "embed"), dtype=cfg.param_dtype)
        }
    elif cfg.frontend == "frames":
        sch["frontend_proj"] = {
            "w": ParamDef((FRAME_DIM, cfg.d_model), (None, "embed"), dtype=cfg.param_dtype)
        }

    if cfg.family == "ssm":
        sch["blocks"] = stack_schema(cfg.num_layers, _ssm_block_schema(cfg))
    elif cfg.family == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        sch["groups"] = stack_schema(groups, stack_schema(per, _ssm_block_schema(cfg)))
        if tail:
            sch["tail"] = stack_schema(tail, _ssm_block_schema(cfg))
        sch["shared_attn"] = {"ln1": L.rmsnorm_schema(cfg.d_model),
                              "attn": L.attention_schema(cfg),
                              "ln2": L.rmsnorm_schema(cfg.d_model),
                              "ffn": L.mlp_schema(cfg)}
    else:
        n_moe_first_dense = cfg.moe.first_k_dense if cfg.moe else 0
        if n_moe_first_dense:
            sch["dense_blocks"] = stack_schema(n_moe_first_dense, _dense_block_schema(cfg))
        sch["blocks"] = stack_schema(
            cfg.num_layers - n_moe_first_dense, _attn_block_schema(cfg)
        )
    return sch


# --------------------------------------------------------------------------
# forward (train / prefill trunk)
# --------------------------------------------------------------------------

def layer_views(blocks: dict) -> list[dict]:
    """The stacked block tree as one tree of views per layer (no copy)."""
    n = next(tree_leaves(blocks)).shape[0]
    return [map_tree(blocks, lambda a, i=i: a[i]) for i in range(n)]


def _attention(bp, x, cfg: ModelConfig, positions):
    apply = MLA.mla_apply if cfg.mla else L.attention_apply
    return apply(bp["attn"], L.rmsnorm_apply(bp["ln1"], x), cfg, positions)


def _attn_block_apply(bp, x, cfg: ModelConfig, positions):
    x = L.constrain(x, "batch", None, None)
    x = x + _attention(bp, x, cfg, positions)
    h = L.rmsnorm_apply(bp["ln2"], x)
    if "router" in bp["ffn"]:  # MoE
        y, aux = MOE.moe_apply(bp["ffn"], h, cfg)
    else:
        y, aux = L.mlp_apply(bp["ffn"], h, cfg), None
    return L.constrain(x + y, "batch", None, None), aux


def _dense_block_apply(bp, x, cfg: ModelConfig, positions):
    x = x + _attention(bp, x, cfg, positions)
    return x + L.mlp_apply(bp["ffn"], L.rmsnorm_apply(bp["ln2"], x), cfg)


def _ssm_block_apply(bp, x, cfg: ModelConfig):
    x = L.constrain(x, "batch", None, None)
    return x + SSM.ssm_apply(bp["ssm"], L.rmsnorm_apply(bp["ln"], x), cfg)


def embed_inputs(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token / frame / patch embedding per family -> [B, S, d]."""
    cdt = cfg.compute_dtype
    if cfg.frontend == "frames":
        return torch.matmul(batch["frames"].to(cdt), params["frontend_proj"]["w"].to(cdt))
    tok = L.embed_apply(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "patch":
        img = torch.matmul(batch["patches"].to(cdt), params["frontend_proj"]["w"].to(cdt))
        tok = torch.cat([img, tok], dim=1)
    return tok


#: the products without batch dims: the ops whose outputs the "dots" policy
#: keeps for the backward pass
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy while gradients are recorded.
    No RNG state is kept: no op of these models draws random numbers."""
    if not cfg.remat:
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kw)

    return body


def _scan_blocks(blocks, x, body_fn, cfg: ModelConfig):
    """Every layer of the stacked ``blocks`` through ``body_fn(bp, x) ->
    (x, aux or None)`` under ``_maybe_remat``: (x, the summed aux, None when
    no layer gives one)."""
    body = _maybe_remat(body_fn, cfg)
    aux = None
    for bp in layer_views(blocks):
        x, a = body(bp, x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward(params, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B,S,d], moe_aux_loss): the aux loss sums the MoE
    layers' (0 without MoE)."""
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def ssm_body(bp, h):
        return _ssm_block_apply(bp, h, cfg), None

    if cfg.family == "ssm":
        x, _ = _scan_blocks(params["blocks"], x, ssm_body, cfg)
    elif cfg.family == "hybrid":
        def group_body(gp, h):
            h, _ = _scan_blocks(gp, h, ssm_body, cfg)
            return _dense_block_apply(params["shared_attn"], h, cfg, positions), None

        x, _ = _scan_blocks(params["groups"], x, group_body, cfg)
        if "tail" in params:
            x, _ = _scan_blocks(params["tail"], x, ssm_body, cfg)
    else:
        if "dense_blocks" in params:
            x, _ = _scan_blocks(
                params["dense_blocks"], x,
                lambda bp, h: (_dense_block_apply(bp, h, cfg, positions), None), cfg)
        x, a = _scan_blocks(
            params["blocks"], x, lambda bp, h: _attn_block_apply(bp, h, cfg, positions), cfg)
        if a is not None:
            aux = aux + a
    return L.rmsnorm_apply(params["final_norm"], x), aux


def _unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"]["table"])


def loss_fn(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The chunked cross-entropy of ``batch["labels"]`` plus the MoE aux
    loss (fp32 scalar)."""
    hidden, aux = forward(params, batch, cfg)
    ce = L.chunked_ce_loss(_unembed_table(params, cfg), hidden, batch["labels"], cfg)
    return ce + aux


def logits_last(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Prefill-style forward returning last-position logits [B, V]."""
    hidden, _ = forward(params, batch, cfg)
    return L.unembed_logits(_unembed_table(params, cfg), hidden[:, -1], cfg)


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts; active excludes unrouted experts."""
    total = param_count(model_schema(cfg))
    active = total
    if cfg.moe:
        n_moe = cfg.num_layers - cfg.moe.first_k_dense
        per_expert = 3 * cfg.d_model * cfg.moe.expert_d_ff
        active -= n_moe * (cfg.moe.num_experts - cfg.moe.top_k) * per_expert
    return total, active


#: the leaves every use reads in fp32 (the norm scales, MLA's latent norm,
#: the SSM's gated norm, decay, skip and step bias): ``compute_params``
#: keeps them in their parameter dtype
FP32_READ = frozenset({"scale", "kv_norm", "norm", "A_log", "D", "dt_bias"})


def compute_leaf(name: str, v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Leaf ``name`` as its uses cast it: unchanged if read in fp32, else
    in the compute dtype."""
    return v if name in FP32_READ else v.to(cfg.compute_dtype)


def compute_params(params: dict, cfg: ModelConfig) -> dict:
    """The weights as every use casts them, made once: each leaf in the
    compute dtype but those read in fp32 (``FP32_READ``), kept in their
    parameter dtype.  Bitwise what the reference's per-use ``.astype``
    computes."""
    return {k: compute_params(v, cfg) if isinstance(v, dict) else compute_leaf(k, v, cfg)
            for k, v in params.items()}


def init_compute_params(cfg: ModelConfig, generator: torch.Generator,
                        device: str | torch.device | None = None) -> dict:
    """``compute_params(init_params(model_schema(cfg), generator, device),
    cfg)`` without holding the parameter-dtype tree: each leaf is drawn in
    ``_leaf_paths`` order, as ``init_params`` draws it, and cast as it is
    drawn.  The same draws, bitwise the same tree."""
    return init_params(model_schema(cfg), generator, device,
                       transform=lambda path, v: compute_leaf(path[-1], v, cfg))


class LanguageModel(nn.Module):
    """The parameter tree of one architecture as an ``nn.Module``: nested
    modules under the schema's keys, each holding its node's leaves as
    parameters.

    ``params`` (a tree of tensors, e.g. the reference's carried across with
    ``schema.params_from_numpy``; moved to ``device`` when one is given) or
    else fresh ``init_params`` drawn from ``generator`` on ``device``
    (``None``: the CUDA card).  Built for serving: no parameter requires a
    gradient, so a forward records no graph.  ``tree()`` hands out the
    parameters themselves, so after ``requires_grad_(True)`` a loss of it
    reaches them."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise TypeError("LanguageModel needs params or a torch.Generator to draw them")
            params = init_params(model_schema(cfg), generator, resolve_device(device))
        elif device is not None:
            dev = resolve_device(device)
            params = map_tree(params, lambda a: a.to(dev))
        self.params = _module_tree(params)
        self.requires_grad_(False)

    def tree(self) -> dict:
        """The parameters as the plain nested dict the functions take."""
        return _plain_tree(self.params)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self.tree(), batch, self.cfg)

    def logits_last(self, batch: dict) -> torch.Tensor:
        return logits_last(self.tree(), batch, self.cfg)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One token per lane at host position ``pos``: (logits, cache),
        the cache updated in place."""
        from repro_torch.models.decode import decode_step

        return decode_step(self.tree(), cache, {"tokens": tokens, "pos": pos}, self.cfg)


def _module_tree(tree: dict) -> nn.Module:
    """A schema node as a module: its leaves as parameters, its sub-trees as
    sub-modules (an MoE node holds both: the experts and ``shared``)."""
    node = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            node.add_module(k, _module_tree(v))
        else:
            node.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return node


def _plain_tree(mod: nn.Module) -> dict:
    out = dict(mod.named_parameters(recurse=False))
    out.update({k: _plain_tree(m) for k, m in mod.named_children()})
    return out
