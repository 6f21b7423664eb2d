"""Architecture configurations (port of ``repro/configs``)."""

from repro_torch.configs.base import (
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    ShapeCell,
    SHAPES,
    applicable_shapes,
    get_config,
    list_archs,
    smoke_config,
)

__all__ = [
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "ShapeCell",
    "SHAPES",
    "applicable_shapes",
    "get_config",
    "list_archs",
    "smoke_config",
]
