"""Model assembly (port of ``repro/models/model.py`` for the attention
families): schema, forward and last-position logits.

The families this port runs:

  dense   — pre-norm GQA attention + (SwiGLU|GeGLU) MLP
  audio   — HuBERT-style encoder-only (bidirectional, frame-embedding stub)
  vlm     — LLaVA-style: projected patch embeddings prepended to the token
            stream, causal LM on top

The families with MoE, MLA, SSM or hybrid layers (arctic, deepseek, mamba2,
zamba2) raise ``NotImplementedError`` naming ROADMAP item 15b, at schema,
forward, cache and decode time.

Layers are stacked on a leading "layers" axis, as in the reference, so its
parameter trees carry across one to one (``schema.params_from_numpy``).
``forward`` walks them with a Python loop over per-layer views
(``layer_views``): that loop stands for both values of ``scan_layers``
(``lax.scan`` and the reference's unrolled loop compute the same thing).
For these families the reference's ``_dense_block_schema`` /
``_dense_block_apply`` (DeepSeek's leading dense layers, zamba2's shared
block) are the attention block itself; they come with item 15b.
``remat`` / ``_maybe_remat`` and ``loss_fn`` are training (item 15d).

``LanguageModel`` is the ``nn.Module`` face of the same functions: it holds
the parameter tree and serves ``forward``, ``logits_last`` and
``decode_step``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
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

#: the families whose every block is GQA attention + an MLP
ATTENTION_FAMILIES = ("dense", "vlm", "audio")


def require_attention_family(cfg: ModelConfig, what: str) -> None:
    """Raise for an architecture whose layers this port does not have yet."""
    if cfg.family not in ATTENTION_FAMILIES or cfg.moe or cfg.mla or cfg.ssm:
        raise NotImplementedError(
            f"{what} for {cfg.name} (family {cfg.family!r}: MoE, MLA, SSM or hybrid "
            "layers) is not ported yet (ROADMAP.md queue 1, item 15b)"
        )


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
    return {"ln1": L.rmsnorm_schema(cfg.d_model), "attn": L.attention_schema(cfg),
            "ln2": L.rmsnorm_schema(cfg.d_model), "ffn": L.mlp_schema(cfg)}


def model_schema(cfg: ModelConfig) -> Schema:
    require_attention_family(cfg, "the parameter schema")
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
    sch["blocks"] = stack_schema(cfg.num_layers, _attn_block_schema(cfg))
    return sch


# --------------------------------------------------------------------------
# forward (train / prefill trunk)
# --------------------------------------------------------------------------

def layer_views(blocks: dict) -> list[dict]:
    """The stacked block tree as one tree of views per layer (no copy)."""
    n = next(tree_leaves(blocks)).shape[0]
    return [map_tree(blocks, lambda a, i=i: a[i]) for i in range(n)]


def _attn_block_apply(bp, x, cfg: ModelConfig, positions):
    a = L.attention_apply(bp["attn"], L.rmsnorm_apply(bp["ln1"], x), cfg, positions)
    x = x + a
    return x + L.mlp_apply(bp["ffn"], L.rmsnorm_apply(bp["ln2"], x), cfg)


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


def forward(params, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B,S,d], moe_aux_loss); the aux loss is 0 for the
    attention families (it comes from MoE routing)."""
    require_attention_family(cfg, "the forward pass")
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp in layer_views(params["blocks"]):
        x = _attn_block_apply(bp, x, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm_apply(params["final_norm"], x), aux


def _unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"]["table"])


def logits_last(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Prefill-style forward returning last-position logits [B, V]."""
    hidden, _ = forward(params, batch, cfg)
    return L.unembed_logits(_unembed_table(params, cfg), hidden[:, -1], cfg)


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts; for the attention families every
    parameter is active (only MoE leaves experts unrouted)."""
    total = param_count(model_schema(cfg))
    return total, total


def compute_params(params: dict, cfg: ModelConfig) -> dict:
    """The weights as every use casts them, made once: each leaf in the
    compute dtype but the norm scales, which the norms read in fp32.
    Bitwise what the reference's per-use ``.astype`` computes."""
    return {k: compute_params(v, cfg) if isinstance(v, dict)
            else v if k == "scale" else v.to(cfg.compute_dtype)
            for k, v in params.items()}


class LanguageModel(nn.Module):
    """The parameter tree of one architecture as an ``nn.Module``: nested
    ``nn.ModuleDict`` / ``nn.ParameterDict`` under the schema's keys.

    ``params`` (a tree of tensors, e.g. the reference's carried across with
    ``schema.params_from_numpy``; moved to ``device`` when one is given) or
    else fresh ``init_params`` drawn from ``generator`` on ``device``
    (``None``: the CUDA card).  Built for serving: no parameter requires a
    gradient."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise TypeError("LanguageModel needs params or a torch.Generator to draw them")
            params = init_params(model_schema(cfg), generator, resolve_device(device))
        else:
            require_attention_family(cfg, "the parameter schema")
            if device is not None:
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
    # a schema node holds either sub-trees or leaves, never both
    if any(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _module_tree(v) for k, v in tree.items()})
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


def _plain_tree(mod: nn.Module) -> dict:
    if isinstance(mod, nn.ParameterDict):
        return {k: p.data for k, p in mod.items()}
    return {k: _plain_tree(m) for k, m in mod.items()}
