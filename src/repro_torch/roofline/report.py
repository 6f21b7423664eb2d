"""Render the roofline table from the dry run's JSON results (port of
``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ARCH_ORDER = (
    "hubert_xlarge", "qwen15_05b", "gemma_7b", "llama3_8b", "stablelm_12b",
    "mamba2_13b", "llava_next_mistral_7b", "zamba2_7b", "arctic_480b",
    "deepseek_v2_lite_16b",
)
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(dir_: str, mesh: str = "single") -> list[dict]:
    out = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            p = Path(dir_) / f"{arch}__{shape}__{mesh}.json"
            if p.exists():
                out.append(json.loads(p.read_text()))
    return out


def table(results: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bottleneck "
           "| model GF/chip | HLO GF/chip | useful | mem/dev GB | note |")
    sep = "|" + "---|" * 11
    rows = [hdr, sep]
    for r in results:
        a, s = r["arch"], r["shape"]
        if "skipped" in r:
            rows.append(f"| {a} | {s} | — | — | — | — | — | — | — | — | SKIP: {r['skipped'][:48]} |")
            continue
        if "error" in r:
            rows.append(f"| {a} | {s} | — | — | — | — | — | — | — | — | ERROR |")
            continue
        f = r["roofline"]
        rows.append(
            f"| {a} | {s} | {f['compute_s']:.4f} | {f['memory_s']:.4f} | "
            f"{f['collective_s']:.4f} | **{f['bottleneck']}** | "
            f"{f['model_gflops']:.0f} | {f['hlo_gflops']:.0f} | "
            f"{f['useful_flops_ratio']:.2f} | {f['memory_per_device_gb']:.1f} | |"
        )
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    print(table(load(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
