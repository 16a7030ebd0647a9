from repro_torch.configs.base import (ModelConfig, MoEConfig, ParallelConfig,
                                     SSMConfig, round_up)
from repro_torch.configs.registry import REGISTRY, get_config

__all__ = ["ModelConfig", "MoEConfig", "ParallelConfig", "REGISTRY",
           "SSMConfig", "get_config", "round_up"]
