"""Multi-node dry run (port of ``repro/launch/dryrun.py``): trace every
(arch x shape x mesh) cell on the meta device and bound its step.

For each cell the dry run builds the production mesh (``launch/mesh.py``:
256 or 512 H100s), abstract parameters / optimizer state / caches and
inputs (tensors on the meta device: no allocation, no card), and records:

  * the FLOPs of the step, counted by ``FlopCounterMode`` while the step
    runs on the meta inputs (forward and ``autograd.grad`` for train),
  * the collectives of the step per mesh axis
    (``roofline.traffic.analytic_collectives``, from the specs of
    ``dist/sharding.py``),
  * the per-device resident state under those specs, plus an activation
    estimate,
  * the three roofline terms and the dominant bottleneck
    (``roofline/analysis.py``, H100 constants).

As in the reference, the cost comes from two reduced models of 1 and 2
layer-units (``reduced_cfg``), extrapolated linearly to the full depth
(``_extrapolate``): two traces at any depth.  The FLOPs per chip are the
traced global count over the chips: work the divisibility fallback
replicates (a dim that does not divide its mesh axes) is counted once, so
the compute term is a lower bound there.  The counter counts the products
(matmuls, batched matmuls, attention kernels), not elementwise work.

Left out, with no torch meaning: XLA's ``memory_analysis`` of the compiled
module (``_memory_bytes``; the ``xla_memory_analysis_gb`` field), its
unfused ``bytes accessed`` (``xla_unfused_gbytes``), the HLO collective
parse, and jit's in/out shardings and donation.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist.sharding import (
    cache_pspecs,
    dp_size,
    local_shape,
    model_pspecs,
    placements,
)
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_axis_sizes
from repro_torch.models import decode as D
from repro_torch.models import model as M
from repro_torch.models.schema import abstract_params, param_bytes, tree_items
from repro_torch.roofline import analysis as R
from repro_torch.roofline import traffic as T
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O

# FSDP threshold: shard params/optimizer over 'data' too once fp32 params +
# moments would exceed a single model-parallel shard's HBM share.
FSDP_PARAM_BYTES = 8e9


def _opt_for(cfg: ModelConfig) -> O.OptConfig:
    moment_dtype = torch.bfloat16 if cfg.param_dtype == torch.bfloat16 else torch.float32
    return O.OptConfig(moment_dtype=moment_dtype)


def _use_fsdp(cfg: ModelConfig) -> bool:
    return param_bytes(M.model_schema(cfg)) > FSDP_PARAM_BYTES


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh, *, fsdp=None):
    """Run one cell's step once on meta inputs under ``FlopCounterMode``,
    inside ``with mesh:`` (so ``layers.constrain`` resolves against it).
    Returns (the counter, meta)."""
    if fsdp is None:
        fsdp = _use_fsdp(cfg)
    batch = D.input_specs(cfg, cell)
    counter = FlopCounterMode(display=False)
    with mesh:
        if cell.kind == "train":
            opt = _opt_for(cfg)
            step = TL.make_train_step(cfg, opt)
            state = TL.abstract_train_state(cfg, opt)
            with counter:
                step(state, batch)
        elif cell.kind == "prefill":
            params = abstract_params(M.model_schema(cfg))
            with counter, torch.inference_mode():
                M.logits_last(params, batch, cfg)
        else:  # decode
            params = abstract_params(M.model_schema(cfg))
            cache = D.init_cache(cfg, cell.global_batch, cell.seq_len, "meta")
            with counter, torch.inference_mode():
                D.decode_step(params, cache, {"tokens": batch["tokens"], "pos": 0}, cfg)
    return counter, {"fsdp": bool(fsdp)}


def unit_count(cfg: ModelConfig) -> int:
    """Number of repeated layer-units (for cost extrapolation)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.moe and cfg.moe.first_k_dense:
        return cfg.num_layers - cfg.moe.first_k_dense
    return cfg.num_layers


def reduced_cfg(cfg: ModelConfig, units: int, cell: ShapeCell) -> ModelConfig:
    """The variant with ``units`` layer-units, traced for the cost.

    Two traces of 1 and 2 units extrapolate linearly to the full depth
    (exact for homogeneous stacks), at the cost of two units whatever the
    depth; the reference compiles the same two variants because XLA's
    cost_analysis counts a scanned body once."""
    kw: dict = {"scan_layers": False}
    if cfg.family == "hybrid":
        groups, per, tail = M.hybrid_layout(cfg)
        kw["num_layers"] = units * per + tail
    elif cfg.moe and cfg.moe.first_k_dense:
        kw["num_layers"] = cfg.moe.first_k_dense + units
    else:
        kw["num_layers"] = units
    if cell.kind == "train":
        kw["loss_chunk"] = cell.seq_len  # single CE chunk, as the reference
    return dataclasses.replace(cfg, **kw)


def _stats_dict(stats: dict) -> dict:
    return {a: {"counts": dict(s.counts), "bytes_by_kind": dict(s.bytes_by_kind)}
            for a, s in stats.items()}


def _module_cost(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh, fsdp) -> dict:
    """The traced FLOPs of one cell (global, and split by op), and its
    analytic collectives per mesh axis."""
    counter, _ = trace_cell(cfg, cell, mesh, fsdp=fsdp)
    coll = T.analytic_collectives(cfg, cell, mesh_axis_sizes(mesh), fsdp=fsdp)
    return {
        "flops": counter.get_total_flops(),
        "flops_by_op": {str(k): v for k, v in counter.get_flop_counts()["Global"].items()},
        "coll_bytes": sum(s.total_bytes for s in coll.values()),
        "coll_by_axis": _stats_dict(coll),
    }


def _extrapolate(c1: dict, c2: dict, units: int) -> dict:
    """Every number of ``c2`` - ``c1`` as a per-unit slope, carried from
    ``c1`` to ``units`` units (nested dicts key by key; a key missing on one
    side counts 0 there)."""
    out = {}
    for k in c1.keys() | c2.keys():
        a, b = c1.get(k, 0), c2.get(k, 0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = _extrapolate(a or {}, b or {}, units)
        else:
            out[k] = a + (b - a) * (units - 1)
    return out


def _resident_bytes(tree: dict, spec_tree: dict, mesh: Mesh) -> float:
    """Exact per-device resident bytes of a (state/cache) tree of meta
    tensors under its specs: the sum of the local shard sizes."""
    total = 0.0
    for (_, t), (_, spec) in zip(tree_items(tree), tree_items(spec_tree)):
        local = local_shape(t.shape, placements(mesh, spec), mesh)
        total += math.prod(local) * t.dtype.itemsize
    return total


def _activation_resident(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh) -> float:
    """Remat stores one [B_loc, S, d] residual per layer plus ~4x one
    layer's working set."""
    dp = dp_size(mesh)
    b_loc = cell.global_batch / dp if cell.global_batch % dp == 0 else cell.global_batch
    s = cell.seq_len if cell.kind != "decode" else 1
    act = b_loc * s * cfg.d_model * 2.0
    if cell.kind == "train":
        return cfg.num_layers * act + 8.0 * act
    return 4.0 * act


def _stats(coll_by_axis: dict) -> dict:
    out = {}
    for axis, c in coll_by_axis.items():
        s = R.CollectiveStats()
        for kind in R.COLLECTIVES:
            s.add(kind, c["bytes_by_kind"].get(kind, 0), int(c["counts"].get(kind, 0)))
        out[axis] = s
    return out


def run_cell(arch: str, shape: str, mesh_name: str, out_dir=None, verbose=True, *,
             cfg: ModelConfig | None = None, cell: ShapeCell | None = None,
             mesh: Mesh | None = None) -> dict:
    """One cell: ``arch`` / ``shape`` / ``mesh_name`` name the registry's
    config, cell and production mesh; ``cfg=``, ``cell=`` and ``mesh=``
    give others (phase ``dryrun`` of ``chip_smoke.py`` runs the card's own
    steps on ``make_host_mesh()``)."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = cell if cell is not None else next(c for c in SHAPES if c.name == shape)
    for c, reason in applicable_shapes(cfg):
        if c.name == shape and reason is not None:
            result = {"arch": arch, "shape": shape, "mesh": mesh_name, "skipped": reason}
            if out_dir:
                _write(out_dir, result)
            if verbose:
                print(f"SKIP {arch}/{shape}/{mesh_name}: {reason}")
            return result

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    chips = mesh.size
    sizes = mesh_axis_sizes(mesh)
    fsdp = _use_fsdp(cfg) if cell.kind == "train" else False

    # exact per-device resident state from the specs + activation estimate
    opt = _opt_for(cfg)
    if cell.kind == "train":
        state_res = _resident_bytes(
            TL.abstract_train_state(cfg, opt),
            TL.train_state_pspecs(cfg, mesh, fsdp=fsdp), mesh,
        )
    elif cell.kind == "prefill":
        state_res = _resident_bytes(
            abstract_params(M.model_schema(cfg)), model_pspecs(cfg, mesh, fsdp=fsdp), mesh)
    else:
        state_res = _resident_bytes(
            abstract_params(M.model_schema(cfg)), model_pspecs(cfg, mesh, fsdp=False), mesh,
        ) + _resident_bytes(
            D.init_cache(cfg, cell.global_batch, cell.seq_len, "meta"),
            cache_pspecs(cfg, mesh, cell.global_batch, cell.seq_len), mesh,
        )
    act_res = _activation_resident(cfg, cell, mesh)
    mem = state_res + act_res

    # per-layer costs from u=1 / u=2 traces, extrapolated to full depth
    units = unit_count(cfg)
    c1 = _module_cost(reduced_cfg(cfg, 1, cell), cell, mesh, fsdp)
    c2 = _module_cost(reduced_cfg(cfg, 2, cell), cell, mesh, fsdp)
    cost = _extrapolate(c1, c2, units)

    total, active = M.param_counts(cfg)
    mf = R.model_flops(cfg, cell, total, active)
    # memory term: the analytic fused-traffic model
    moment_bytes = 2 if cfg.param_dtype == torch.bfloat16 else 4
    fused_bytes = T.analytic_memory_bytes(cfg, cell, sizes, fsdp=fsdp,
                                          moment_bytes=moment_bytes)
    roof = R.analyze(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        cost={"flops": cost["flops"] / chips, "bytes accessed": fused_bytes},
        collectives=_stats(cost["coll_by_axis"]), link_bw=R.link_bandwidth(sizes),
        model_flops_fleet=mf, memory_per_device_bytes=mem,
    )
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "params_total": total, "params_active": active, "fsdp": bool(fsdp),
        "units": units,
        "roofline": json.loads(roof.to_json()),
        "state_resident_gb": state_res / 1e9,
        "activation_resident_gb": act_res / 1e9,
        "flops_by_op": cost["flops_by_op"],
        "collectives_by_axis": cost["coll_by_axis"],
        "link_gbps_by_axis": {a: r / 1e9 for a, r in R.link_bandwidth(sizes).items()},
    }
    if verbose:
        print(
            f"OK {arch}/{shape}/{mesh_name}: mem/dev={mem/1e9:.2f}GB "
            f"flops/chip={roof.hlo_gflops:.1f}G bytes/chip={roof.hlo_gbytes:.1f}G "
            f"coll/chip={roof.collective_gbytes:.3f}G bottleneck={roof.bottleneck} "
            f"terms(c/m/x)=({roof.compute_s:.4f}/{roof.memory_s:.4f}/{roof.collective_s:.4f})s",
            flush=True,
        )
    if out_dir:
        _write(out_dir, result)
    return result


def _write(out_dir, result) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    (out / name).write_text(json.dumps(result, indent=1))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or args.shape is None else [args.shape]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                try:
                    run_cell(arch, shape, mesh_name, out_dir=args.out)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((arch, shape, mesh_name, repr(e)))
                    traceback.print_exc()
                    _write(args.out, {"arch": arch, "shape": shape,
                                      "mesh": mesh_name, "error": repr(e)})
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
