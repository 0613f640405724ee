from repro_torch.configs.base import DEQSettings, ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "DEQSettings", "ModelConfig", "get_config",
           "smoke_config"]
