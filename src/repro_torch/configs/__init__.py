from repro_torch.configs.base import (
    DEQSettings,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    TrainConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import ARCHS, get_config, smoke_config

__all__ = [
    "ARCHS", "DEQSettings", "MLAConfig", "MoEConfig", "ModelConfig",
    "SSMConfig", "TrainConfig", "XLSTMConfig", "get_config", "smoke_config",
]
