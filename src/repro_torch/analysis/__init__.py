"""Static contract analysis for the port's simx round-stage runtime (port
of ``repro.analysis``).

  * ``repro_torch.analysis.specs``: the shape/dtype contracts that every
    tensor field of the simx dataclasses carries in its metadata (the
    reference's strings), and ``check_state`` to hold a live state, a
    batched one (leading point axis) or a lane-stacked one, against them.
  * ``repro_torch.analysis.simxlint``: an AST pass (``python -m
    repro_torch.analysis.simxlint src/repro_torch/simx``) that finds every
    host read inside a round step (TH001: each blocks a CUDA graph of the
    round) and the stage-contract breaches SC101 / SC102.
  * ``repro_torch.analysis.speccheck``: constructors, steps, stage
    helpers, stream layouts and the sharded drivers held to the contracts
    at a small size (``python -m repro_torch.analysis.speccheck --device
    cpu``).
  * ``repro_torch.analysis.sentinels``: host syncs counted under torch's
    sync-debug mode (``count_syncs``, ``assert_syncs_at_most``), the torch
    counterpart of the reference's compile counter.
"""

from repro_torch.analysis.specs import (  # noqa: F401
    Spec,
    SpecError,
    check_state,
    field_specs,
    missing_specs,
    parse_spec,
)
