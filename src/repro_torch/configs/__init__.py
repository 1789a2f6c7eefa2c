from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import ALL_ARCHS, all_configs, get_config

__all__ = ["ModelConfig", "MoEConfig", "ALL_ARCHS", "all_configs", "get_config"]
