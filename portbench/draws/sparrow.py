"""Sparrow's draws: each job's probe targets (Sparrow §3.2)."""

import torch


def make(cfg: dict, trace: dict, seed: int, device) -> dict:
    """``targets int32[J, kmax]``: each job's first ``min(d n, W)`` entries a
    uniform ordered sample of distinct workers (batch sampling): the workers
    of the ``kmax`` largest of W uniform scores, in descending order of
    score."""
    W = cfg["num_workers"]
    job_ntasks = trace["job_ntasks"]
    kmax = int(min(cfg["probe_ratio"] * int(job_ntasks.max()), W))
    gen = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand((len(job_ntasks), W), generator=gen, dtype=torch.float64,
                        device=device)
    return {"targets": torch.topk(scores, kmax, dim=1).indices.to(torch.int32)}
