"""The event backend's baseline schedulers (copies of
``repro/core/baselines``): Sparrow, Eagle and Pigeon."""

from repro_torch.core.baselines.sparrow import Sparrow, SparrowConfig
from repro_torch.core.baselines.eagle import Eagle, EagleConfig
from repro_torch.core.baselines.pigeon import Pigeon, PigeonConfig

__all__ = [
    "Sparrow",
    "SparrowConfig",
    "Eagle",
    "EagleConfig",
    "Pigeon",
    "PigeonConfig",
]
