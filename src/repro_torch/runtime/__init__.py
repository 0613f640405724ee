from repro_torch.runtime.ft import (
    ElasticMeshManager,
    PreemptionGuard,
    StragglerWatchdog,
)
from repro_torch.runtime.trainer import Trainer, TrainState

__all__ = [
    "Trainer", "TrainState", "ElasticMeshManager", "PreemptionGuard",
    "StragglerWatchdog",
]
