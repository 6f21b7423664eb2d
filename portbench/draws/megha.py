"""Megha's draws: each GM's priority order over the workers (Megha §3.3)."""

import torch


def make(cfg: dict, trace: dict, seed: int, device) -> dict:
    """``orders int32[G, W]``: each GM's own partitions' workers shuffled
    first, then every other worker shuffled.  A worker's partition belongs
    to GM ``(w % (W / L)) // (W / L / G)``."""
    W, G, L = cfg["num_workers"], cfg["num_gms"], cfg["num_lms"]
    if W % (G * L):
        raise ValueError(f"{W} workers do not divide into {G} x {L} partitions")
    per_lm = W // L
    owner = (torch.arange(W, device=device) % per_lm) // (per_lm // G)
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.rand((G, W), generator=gen, dtype=torch.float64, device=device)
    keys = keys + 2.0 * (owner[None, :] != torch.arange(G, device=device)[:, None])
    return {"orders": torch.argsort(keys, dim=1, stable=True).to(torch.int32)}
