"""Pigeon's draws: none.  Its groups, its distribution of tasks over them
and its queues follow from the configuration and the trace (Pigeon §3)."""


def make(cfg: dict, trace: dict, seed: int, device) -> dict:
    return {}
