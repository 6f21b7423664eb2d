"""Three-term roofline of one step on a mesh of H100s (port of
``repro/roofline/analysis.py``).

    compute    = FLOPs per chip        / PEAK_FLOPS
    memory     = HBM bytes per chip    / HBM_BW
    collective = sum over mesh axes of collective bytes per chip on that
                 axis / the axis' link rate

The FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the step traced on the meta device (``launch/dryrun.py``), the bytes by
``traffic.analytic_memory_bytes`` and the collectives by
``traffic.analytic_collectives``: there is no compiled module to parse, so
``analyze`` takes a ``CollectiveStats`` per mesh axis where the reference
parses HLO text.

Hardware constants, NVIDIA H100 SXM5 at its 700 W limit:
  * ``PEAK_FLOPS`` 989 TFLOP/s, bf16 dense on the tensor cores, and
    ``HBM_BW`` 3.35 TB/s of HBM3 (NVIDIA H100 Tensor Core GPU data sheet,
    https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet);
  * ``NVLINK_BW`` 450 GB/s each way per GPU, for an axis inside one 8-GPU
    node (fourth-generation NVLink, 900 GB/s bidirectional per GPU:
    https://www.nvidia.com/en-us/data-center/nvlink/);
  * ``IB_BW`` 50 GB/s per GPU, for an axis that spans nodes (one NDR
    InfiniBand port of 400 Gb/s per GPU, as in the DGX H100:
    https://docs.nvidia.com/dgx/dgxh100-user-guide/introduction-to-dgxh100.html).

Every quantity is per chip; ``step_time_s`` is the largest term (no
overlap), a bound no run of the step can beat.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s per GPU
HBM_BW = 3.35e12         # bytes/s per GPU
NVLINK_BW = 450e9        # bytes/s each way per GPU, inside a node
IB_BW = 50e9             # bytes/s per GPU, between nodes
GPUS_PER_NODE = 8

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    """Collectives of one step on one mesh axis: ops and bytes per chip by
    kind."""

    counts: dict = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    bytes_by_kind: dict = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: float, count: int = 1) -> None:
        self.counts[kind] += count
        self.bytes_by_kind[kind] += nbytes


def link_bandwidth(mesh_sizes: dict) -> dict[str, float]:
    """Each axis' link rate: NVLink where the axis' devices share an 8-GPU
    node (the axes are laid out minor-last, so an axis spans the product of
    its own size and those after it), InfiniBand where it spans nodes."""
    out, span = {}, 1
    for axis in reversed(list(mesh_sizes)):
        span *= mesh_sizes[axis]
        out[axis] = NVLINK_BW if span <= GPUS_PER_NODE else IB_BW
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float          # per chip
    hlo_gbytes: float          # per chip
    collective_gbytes: float   # per chip
    model_gflops: float        # 6*N*D (dense) or 6*N_active*D; fleet-wide / chips
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_flops_ratio: float
    collective_counts: dict
    memory_per_device_gb: float
    step_time_s: float         # max of the three terms (no-overlap bound)
    roofline_fraction: float   # compute_s / step_time_s (how compute-bound)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    collectives: dict,
    link_bw: dict,
    model_flops_fleet: float,
    memory_per_device_bytes: float,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
) -> Roofline:
    """``cost``: per-chip ``flops`` and ``bytes accessed``; ``collectives``:
    a ``CollectiveStats`` per mesh axis, each over ``link_bw[axis]``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll_bytes = sum(c.total_bytes for c in collectives.values())
    compute_s = flops / peak_flops
    memory_s = byts / hbm_bw
    collective_s = sum((c.total_bytes / link_bw[a] for a, c in collectives.items()), 0.0)
    counts = dict.fromkeys(COLLECTIVES, 0)
    for c in collectives.values():
        for k, n in c.counts.items():
            counts[k] += n
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    model_flops_chip = model_flops_fleet / chips
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_gflops=flops / 1e9,
        hlo_gbytes=byts / 1e9,
        collective_gbytes=coll_bytes / 1e9,
        model_gflops=model_flops_chip / 1e9,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        useful_flops_ratio=(model_flops_chip / flops) if flops else 0.0,
        collective_counts=counts,
        memory_per_device_gb=memory_per_device_bytes / 1e9,
        step_time_s=step,
        roofline_fraction=(compute_s / step) if step else 0.0,
    )


def model_flops(cfg, cell, param_count: int, active_param_count: int) -> float:
    """MODEL_FLOPS: 6*N*D for train, 2*N*D for inference forward (prefill),
    2*N_active*D_new for decode (D_new = batch tokens)."""
    d_tokens = cell.global_batch * cell.seq_len
    n = active_param_count
    if cell.kind == "train":
        return 6.0 * n * d_tokens
    if cell.kind == "prefill":
        return 2.0 * n * d_tokens
    # decode: one token per sequence
    return 2.0 * n * cell.global_batch
