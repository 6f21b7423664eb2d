"""simx: the round-synchronous simulation backend, in PyTorch.

Port of ``repro.simx`` for the megha, pigeon and oracle rules:
fixed-timestep rounds over dense tensors, driven by a host loop, with
every rule's match going through the rank-and-select kernel
(``repro_torch.kernels``).  Select it via
``repro_torch.sim.simulator.run_simulation(..., backend="simx")``; run a
whole Fig. 2 (load x seed) grid as one batched program with
``fig2_sweep``.
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
    simulate_fixed,
)
from repro_torch.simx.state import (
    CoreState,
    MeghaState,
    OracleState,
    PigeonState,
    SimxConfig,
    TaskArrays,
    export_workload,
    init_megha_state,
    init_oracle_state,
    init_pigeon_state,
)
from repro_torch.simx.sweep import (
    SweepPlan,
    fig2_plan,
    fig2_sweep,
    make_load_grid,
    point_summary,
    sweep_grid,
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
    "PigeonState",
    "SweepPlan",
    "compose_step",
    "default_match_fn",
    "estimate_rounds",
    "export_workload",
    "fig2_plan",
    "fig2_sweep",
    "init_megha_state",
    "init_oracle_state",
    "init_pigeon_state",
    "job_delays_from_state",
    "make_load_grid",
    "point_summary",
    "register_rule",
    "run_to_completion",
    "scan_rounds",
    "simulate_fixed",
    "simulate_workload",
    "sweep_grid",
]
