"""Perf hillclimb (port of ``repro/launch/hillclimb.py``): measure
named variants of the three chosen cells on the production mesh.

For each (cell, variant) it traces the u=1 / u=2 reduced models on the meta
device (``dryrun._module_cost``), extrapolates the FLOPs and collectives to
full depth, recomputes the analytic memory term, and appends a row to
``experiments/perf_torch/hillclimb.json``.  Variants that differ only in
where the partitioner places data (zamba2's SSM constraints, arctic's
round 3) give equal terms here: ``constrain`` changes no count.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only arctic,zamba,llama]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import (
    _extrapolate,
    _module_cost,
    _use_fsdp,
    reduced_cfg,
    unit_count,
)
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.models import model as M
from repro_torch.roofline import analysis as R
from repro_torch.roofline import traffic as T

CELL = {c.name: c for c in SHAPES}
OUT = "experiments/perf_torch"


def measure(tag: str, cfg, cell, *, fsdp: bool) -> dict:
    mesh = make_production_mesh()
    chips = mesh.size
    sizes = mesh_axis_sizes(mesh)
    t0 = time.time()
    c1 = _module_cost(reduced_cfg(cfg, 1, cell), cell, mesh, fsdp)
    c2 = _module_cost(reduced_cfg(cfg, 2, cell), cell, mesh, fsdp)
    cost = _extrapolate(c1, c2, unit_count(cfg))
    flops = cost["flops"] / chips
    link = R.link_bandwidth(sizes)
    coll_by_axis = {a: sum(c["bytes_by_kind"].values())
                    for a, c in cost["coll_by_axis"].items()}
    moment_bytes = 2 if cfg.param_dtype == torch.bfloat16 else 4
    fused = T.analytic_memory_bytes(cfg, cell, sizes, fsdp=fsdp, moment_bytes=moment_bytes)
    total, active = M.param_counts(cfg)
    mf = R.model_flops(cfg, cell, total, active)
    compute_s = flops / R.PEAK_FLOPS
    memory_s = fused / R.HBM_BW
    coll_s = sum(b / link[a] for a, b in coll_by_axis.items())
    step = max(compute_s, memory_s, coll_s)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    row = {
        "tag": tag,
        "arch": cfg.name,
        "shape": cell.name,
        "flops_g": flops / 1e9,
        "coll_gb": sum(coll_by_axis.values()) / 1e9,
        "coll_gb_by_axis": {a: b / 1e9 for a, b in coll_by_axis.items()},
        "mem_gb": fused / 1e9,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "step_s": step,
        "bottleneck": max(terms, key=terms.get),
        "useful": (mf / chips / flops) if flops else 0.0,
        "model_flops_chip_g": mf / chips / 1e9,
        "wall_s": time.time() - t0,
    }
    print(
        f"{tag:42s} c={compute_s:8.4f}s m={memory_s:7.4f}s x={coll_s:8.4f}s "
        f"step={step:8.4f}s [{row['bottleneck']}]", flush=True,
    )
    return row


def _append(out: str, rows: list[dict]) -> Path:
    d = Path(out)
    d.mkdir(parents=True, exist_ok=True)
    f = d / "hillclimb.json"
    prev = json.loads(f.read_text()) if f.exists() else []
    f.write_text(json.dumps(prev + rows, indent=1))
    return f


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="arctic,zamba,llama")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rows = []

    if "llama" in args.only:
        cfg = get_config("llama3_8b")
        cell = CELL["decode_32k"]
        rows.append(measure("llama3_decode/v1_bf16_weights",
                            dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                            cell, fsdp=False))
        rows.append(measure(
            "llama3_decode/v2_bf16_weights+fp8_cache",
            dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                                cache_dtype=torch.float8_e4m3fn),
            cell, fsdp=False))
        cellt = CELL["train_4k"]
        rows.append(measure("llama3_train/v1_ce_shard_fix", cfg, cellt,
                            fsdp=_use_fsdp(cfg)))

    if "zamba" in args.only:
        cfg = get_config("zamba2_7b")
        cell = CELL["train_4k"]
        rows.append(measure(
            "zamba2_train/v1_ce_fix_only",
            dataclasses.replace(cfg, ssm_shard_constraints=False),
            cell, fsdp=_use_fsdp(cfg)))
        rows.append(measure("zamba2_train/v2_ce+ssm_constraints", cfg, cell,
                            fsdp=_use_fsdp(cfg)))

    if "arctic" in args.only:
        cfg = get_config("arctic_480b")
        cell = CELL["train_4k"]
        rows.append(measure("arctic_train/v1_ce_fix_einsum_dispatch", cfg,
                            cell, fsdp=True))
        cfg2 = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="sort"))
        rows.append(measure("arctic_train/v2_sort_dispatch", cfg2, cell,
                            fsdp=True))

    f = _append(args.out, rows)
    print(f"wrote {len(rows)} rows -> {f}")


def extra_round(out: str = OUT) -> list[dict]:
    """Iteration round 2: remat policy "dots" (the products' outputs kept,
    so the backward pass recomputes neither them nor their collectives)."""
    rows = []
    cfg = get_config("arctic_480b")
    rows.append(measure(
        "arctic_train/v3_remat_dots",
        dataclasses.replace(cfg, remat_policy="dots"),
        CELL["train_4k"], fsdp=True))
    zcfg = get_config("zamba2_7b")
    rows.append(measure(
        "zamba2_train/v3_remat_dots",
        dataclasses.replace(zcfg, remat_policy="dots"),
        CELL["train_4k"], fsdp=_use_fsdp(zcfg)))
    _append(out, rows)
    print("extra_round done")
    return rows


def arctic_round3(out: str = OUT) -> list[dict]:
    """Iteration round 3 (arctic): the reference pinned the MoE dispatch
    one-hots group-sharded; the port's specs are the same as round 2's."""
    rows = []
    cfg = get_config("arctic_480b")
    rows.append(measure(
        "arctic_train/v4_dispatch_constraints+remat_dots",
        dataclasses.replace(cfg, remat_policy="dots"),
        CELL["train_4k"], fsdp=True))
    _append(out, rows)
    print("arctic_round3 done")
    return rows


if __name__ == "__main__":
    main()
