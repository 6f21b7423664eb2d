"""simx: the round-synchronous simulation backend, in PyTorch.

Port of ``repro.simx`` for all five rules (megha, sparrow, eagle, pigeon
and the oracle): fixed-timestep rounds over dense tensors, driven by a
host loop, with every rule's match going through the rank-and-select
kernel (``repro_torch.kernels``).  Select it via
``repro_torch.sim.simulator.run_simulation(..., backend="simx")``; run a
whole Fig. 2 (load x seed) grid as one batched program with
``fig2_sweep``, and the Fig. 4 (fault severity x seed) grid with
``fig4_sweep``.  Faults enter a run as a ``FaultPlan`` or a dense
``FaultSchedule`` (``faults=``); telemetry (``TelemetryConfig`` ->
``SimxRun.timeline``) and delay provenance (``provenance=True`` ->
``SimxRun.provenance``, ``mean_<component>`` sweep columns) are optional
stages of the same runs.  ``run_steady_state`` streams an open-loop
arrival process (``repro_torch.workload.synth``) through a ring-buffer
trace window for any rule, with a P² sketch of the job delays on the
device (``simx/stream.py``).  ``simx/shard.py`` splits a grid's batch over
a mesh of devices (``sharded_fig2_sweep``, ``sharded_fig4_sweep``) and
runs a whole load curve of streams as one lane-batched program
(``sharded_steady_state``).
"""

from repro_torch.simx.engine import (
    SimxRun,
    estimate_rounds,
    run_to_completion,
    simulate_workload,
)
from repro_torch.simx.faults import (
    FaultPlan,
    FaultSchedule,
    GmOutage,
    WorkerFailure,
    empty_schedule,
    fault_grid_schedule,
    is_empty,
    jobs_with_reservation,
)
from repro_torch.simx.provenance import (
    COMPONENTS,
    Provenance,
    decompose_delays,
    init_provenance,
)
from repro_torch.simx.runtime import (
    RULES,
    Draws,
    Rule,
    compose_step,
    default_match_fn,
    job_delays_from_state,
    register_rule,
    rule_draws,
    scan_rounds,
    simulate_fixed,
)
from repro_torch.simx.state import (
    CoreState,
    EagleState,
    MeghaState,
    OracleState,
    PigeonState,
    QueueState,
    SimxConfig,
    SparrowState,
    TaskArrays,
    export_workload,
    init_eagle_state,
    init_megha_state,
    init_oracle_state,
    init_pigeon_state,
    init_sparrow_state,
    probe_edge_layout,
)
from repro_torch.simx.shard import (
    Mesh,
    sharded_fig2_sweep,
    sharded_fig4_sweep,
    sharded_steady_state,
    sweep_mesh,
)
from repro_torch.simx.stream import SteadyRun, run_steady_state, state_nbytes, stream_config
from repro_torch.simx.sweep import (
    SweepPlan,
    check_probe_memory,
    fault_sweep_grid,
    fig2_plan,
    fig2_sweep,
    fig4_plan,
    fig4_sweep,
    make_load_grid,
    point_summary,
    probe_memory_bytes,
    sweep_grid,
)
from repro_torch.simx.telemetry import TelemetryConfig, Timeline

__all__ = [
    "COMPONENTS",
    "Provenance",
    "TelemetryConfig",
    "Timeline",
    "decompose_delays",
    "init_provenance",
    "RULES",
    "Draws",
    "Rule",
    "SimxRun",
    "SimxConfig",
    "TaskArrays",
    "CoreState",
    "FaultPlan",
    "FaultSchedule",
    "GmOutage",
    "WorkerFailure",
    "QueueState",
    "MeghaState",
    "SparrowState",
    "EagleState",
    "OracleState",
    "PigeonState",
    "SteadyRun",
    "SweepPlan",
    "Mesh",
    "check_probe_memory",
    "compose_step",
    "default_match_fn",
    "empty_schedule",
    "estimate_rounds",
    "export_workload",
    "fault_grid_schedule",
    "fault_sweep_grid",
    "fig2_plan",
    "fig2_sweep",
    "fig4_plan",
    "fig4_sweep",
    "init_eagle_state",
    "init_megha_state",
    "init_oracle_state",
    "init_pigeon_state",
    "init_sparrow_state",
    "is_empty",
    "job_delays_from_state",
    "jobs_with_reservation",
    "make_load_grid",
    "point_summary",
    "probe_edge_layout",
    "probe_memory_bytes",
    "register_rule",
    "rule_draws",
    "run_steady_state",
    "run_to_completion",
    "scan_rounds",
    "sharded_fig2_sweep",
    "sharded_fig4_sweep",
    "sharded_steady_state",
    "simulate_fixed",
    "simulate_workload",
    "state_nbytes",
    "stream_config",
    "sweep_grid",
    "sweep_mesh",
]
