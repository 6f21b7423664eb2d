"""simx: the round-synchronous simulation backend, in PyTorch.

Port of ``repro.simx`` for the megha and oracle rules: fixed-timestep
rounds over dense tensors, driven by a host loop, with every rule's match
going through the rank-and-select kernel (``repro_torch.kernels``).
Select it via ``repro_torch.sim.simulator.run_simulation(...,
backend="simx")``.
"""

from repro_torch.simx.engine import (
    SimxRun,
    estimate_rounds,
    run_to_completion,
    simulate_workload,
)
from repro_torch.simx.runtime import (
    RULES,
    Rule,
    compose_step,
    default_match_fn,
    job_delays_from_state,
    register_rule,
    scan_rounds,
)
from repro_torch.simx.state import (
    CoreState,
    MeghaState,
    OracleState,
    SimxConfig,
    TaskArrays,
    export_workload,
    init_megha_state,
    init_oracle_state,
)

__all__ = [
    "RULES",
    "Rule",
    "SimxRun",
    "SimxConfig",
    "TaskArrays",
    "CoreState",
    "MeghaState",
    "OracleState",
    "compose_step",
    "default_match_fn",
    "estimate_rounds",
    "export_workload",
    "init_megha_state",
    "init_oracle_state",
    "job_delays_from_state",
    "register_rule",
    "run_to_completion",
    "scan_rounds",
    "simulate_workload",
]
