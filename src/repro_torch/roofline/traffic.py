"""Analytic models of a step's HBM traffic and collectives, per chip (port
of ``repro/roofline/traffic.py``, plus ``analytic_collectives``).

``analytic_memory_bytes`` is the roofline's memory term: a *fused
lower-bound* model of what a well-fused execution must move, per chip per
step, arithmetic for arithmetic the reference's.

Accounting (bytes, per chip):

train:
  weights       2 reads (fwd+bwd)                    Ploc * wb
  grads         1 write + 1 read                     Ploc * 4       (fp32)
  adam          m,v read+write, p write              Ploc * 5 * mb
  activations   remat: save 1 + read 1 + recompute   Lu * act * C_ACT
  CE logits     fwd write+read + bwd recompute       3 * tok * Vloc * 2

prefill:
  weights 1 read + activations (no bwd) + cache 1 write

decode:
  weights 1 read (MoE: only routed experts) + cache 1 read + 1 slot write

act = tokens_loc * d_model * 2 bytes; MoE layers add dispatch/expert-buffer
traffic ~ (1 + 0.75*top_k) * act.  Constants are coarse by design — the term
is a lower bound whose *ratios across cells and iterations* are the signal.

``analytic_collectives`` stands where the reference parses the compiled
HLO for collectives: there is no compiled module, so it models the
collectives a step on the mesh needs from the specs of ``dist/sharding.py``
(the parameters' ``model_pspecs``), per chip and per mesh axis, in the same
coarse style.  Each collective's bytes are its full buffer (the gathered
result of an all-gather, the unscattered input of a reduce-scatter, the
buffer of an all-reduce or all-to-all), of which a ring moves (n - 1) / n;
a collective over several axes ("pod" and "data") counts once on each, as
a hierarchical schedule runs it.  Axes of size 1 carry nothing.

  * Gradients (train).  For each parameter leaf and each data axis
    ("data", and "pod" on the multi-pod mesh): without FSDP on that axis
    one all-reduce of the leaf's local fp32 gradient.
  * FSDP (train).  For a leaf sharded over "data": two all-gathers of the
    leaf in its parameter dtype (the forward pass, and the backward pass or
    its remat recompute) and a reduce-scatter of its fp32 gradient.
  * Tensor parallel.  A block whose weights are split over "model"
    (attention, MLP, SSM; MoE's shared and parallel dense MLPs): one
    all-reduce of the block's ``[B_loc, S, d]`` output in the compute dtype
    per forward.  Training adds one in the backward pass and, under remat
    "full", one in the recompute ("dots" keeps the products' outputs, so
    the recompute needs none).
  * Mixture of experts.  With the experts split over "model": two
    all-to-alls of the dispatched tokens (``tokens * top_k *
    capacity_factor * d`` in the compute dtype) per MoE layer and pass.
  * Vocabulary-sharded unembedding.  With the table split over "model":
    an all-gather of the fp32 logits ``[B_loc, V]`` (decode, prefill's last
    position), or, in training, of the CE's per-token statistics (max,
    sum of exponentials, gold logit: 3 fp32 a token and shard) in the
    forward pass and the recompute.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import decode as D
from repro_torch.models import model as M
from repro_torch.models.schema import _leaf_paths, param_bytes, param_count, tree_items
from repro_torch.roofline.analysis import CollectiveStats

C_ACT_TRAIN = 6.0   # save + bwd read + recompute intermediates
C_ACT_FWD = 2.0     # write + read once


def _tree_bytes(spec_tree) -> int:
    return sum(math.prod(shape) * dtype.itemsize for shape, dtype in spec_tree.values())


def analytic_memory_bytes(
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh_sizes: dict,
    *,
    fsdp: bool,
    moment_bytes: int = 4,
) -> float:
    mp = mesh_sizes["model"]
    chips = 1
    for v in mesh_sizes.values():
        chips *= v
    dp = chips // mp

    sch = M.model_schema(cfg)
    pb = param_bytes(sch)
    pn = param_count(sch)
    wb = pb / max(1, pn)  # average weight bytes/elem
    ploc_elems = pn / mp / (dp if fsdp else 1)
    ploc = ploc_elems * wb

    b_loc = cell.global_batch / dp if cell.global_batch % dp == 0 else cell.global_batch
    s = cell.seq_len if cell.kind != "decode" else 1
    tok = b_loc * s
    act = tok * cfg.d_model * 2.0
    lu = cfg.num_layers
    moe_factor = 1.0
    if cfg.moe:
        moe_factor = 1.0 + 0.75 * cfg.moe.top_k
    vloc = cfg.padded_vocab / mp if cfg.padded_vocab % mp == 0 else cfg.padded_vocab

    if cell.kind == "train":
        t = 2.0 * ploc
        t += ploc_elems * 4.0 * 2.0            # grads
        t += ploc_elems * moment_bytes * 5.0   # adam m,v rw + p write
        t += lu * act * C_ACT_TRAIN * moe_factor
        t += 3.0 * tok * vloc * 2.0
        return t

    cache_loc = _tree_bytes(D.cache_spec(cfg, cell.global_batch, cell.seq_len)) / chips

    if cell.kind == "prefill":
        t = ploc
        t += lu * act * C_ACT_FWD * moe_factor
        t += tok * vloc * 2.0 / s              # last-position logits only
        t += cache_loc                          # cache write
        return t

    # decode: weight reads limited to routed experts when tokens are few
    w_read = ploc
    if cfg.moe:
        # EP: every chip owns E/mp experts; the *global* token batch decides
        # how many of them see work this step.
        touched = min(
            1.0, (cell.global_batch * cfg.moe.top_k) / max(1, cfg.moe.num_experts)
        )
        n_moe = cfg.num_layers - cfg.moe.first_k_dense
        expert_elems = n_moe * cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.expert_d_ff
        expert_loc = expert_elems / mp / (dp if fsdp else 1) * wb
        w_read = (ploc - expert_loc) + expert_loc * touched
    t = w_read
    t += cache_loc                              # full cache read
    t += lu * act * C_ACT_FWD * moe_factor
    t += tok * vloc * 2.0
    return t


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _on_model(spec_tree) -> bool:
    """Whether any leaf of a ``P`` (sub)tree is split over "model"."""
    def parts(spec):
        for part in spec:
            yield from part if isinstance(part, tuple) else (part,)

    return any("model" in parts(s) for _, s in tree_items(spec_tree))


def analytic_collectives(
    cfg: ModelConfig, cell: ShapeCell, mesh_sizes: dict, *, fsdp: bool
) -> dict[str, CollectiveStats]:
    """The collectives of one step of ``cell`` on a mesh of ``mesh_sizes``,
    per chip, as a ``CollectiveStats`` per mesh axis (see the module
    docstring for the model)."""
    from repro_torch.dist.sharding import local_shape, model_pspecs, placements

    mesh = Mesh(tuple(mesh_sizes.values()), tuple(mesh_sizes))
    out = {a: CollectiveStats() for a in mesh_sizes}
    data_axes = [a for a in ("pod", "data") if mesh_sizes.get(a, 1) > 1]
    mp = mesh_sizes.get("model", 1)
    specs = model_pspecs(cfg, mesh, fsdp=fsdp)
    train = cell.kind == "train"

    # gradients and FSDP: per parameter leaf
    if train:
        spec_of = dict(tree_items(specs))
        for path, pd in _leaf_paths(M.model_schema(cfg)):
            spec = spec_of[path]
            local = math.prod(local_shape(pd.shape, placements(mesh, spec), mesh))
            sharded = {a for part in spec if part is not None
                       for a in (part if isinstance(part, tuple) else (part,))}
            for a in data_axes:
                if a in sharded:
                    full = local * mesh_sizes[a]
                    out[a].add("all-gather", 2 * full * pd.dtype.itemsize, 2)
                    out[a].add("reduce-scatter", full * 4)
                else:
                    out[a].add("all-reduce", local * 4)

    if mp <= 1:
        return out
    model = out["model"]
    dp = math.prod(mesh_sizes[a] for a in ("pod", "data") if a in mesh_sizes)
    b_loc = cell.global_batch // dp if cell.global_batch % dp == 0 else cell.global_batch
    tokens = b_loc * (cell.seq_len if cell.kind != "decode" else 1)
    act = tokens * cfg.d_model * cfg.compute_dtype.itemsize
    passes = 2 + (cfg.remat and cfg.remat_policy == "full") if train else 1

    def tp(tree, n: int) -> None:
        if n and _on_model(tree):
            model.add("all-reduce", n * passes * act, n * passes)

    def ffn(tree, n: int) -> None:
        if "router" not in tree:
            tp(tree, n)
            return
        m = cfg.moe
        if tree["w_gate"][1] == "model":  # experts split: expert parallel
            moved = tokens * m.top_k * m.capacity_factor * cfg.d_model
            model.add("all-to-all", 2 * n * passes * moved * cfg.compute_dtype.itemsize,
                      2 * n * passes)
        else:
            tp({k: tree[k] for k in ("w_gate", "w_up", "w_down")}, n)
        for branch in ("shared", "dense"):
            if branch in tree:
                tp(tree[branch], n)

    def stack(tree, n: int) -> None:
        if "ssm" in tree:
            tp(tree["ssm"], n)
            return
        tp(tree["attn"], n)
        ffn(tree["ffn"], n)

    if cfg.family == "hybrid":
        groups, per, tail = M.hybrid_layout(cfg)
        stack(specs["groups"], groups * per)
        if tail:
            stack(specs["tail"], tail)
        stack(specs["shared_attn"], groups)
    else:
        if "dense_blocks" in specs:
            stack(specs["dense_blocks"], cfg.moe.first_k_dense)
        stack(specs["blocks"], cfg.num_layers - (cfg.moe.first_k_dense if cfg.moe else 0))

    table = specs["embed" if cfg.tie_embeddings else "lm_head"]["table"]
    if table[0] == "model":
        if train:
            model.add("all-gather", 2 * tokens * 3 * 4 * mp, 2)
        else:
            model.add("all-gather", b_loc * cfg.padded_vocab * 4)
    return out
