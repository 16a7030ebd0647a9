"""The port's model configurations: the dataclasses of ``base`` and the
registry of the archs it serves (MoE: qwen15-moe-a27b,
moonshot-v1-16b-a3b, switch128, mixtral-8x7b; SSM and hybrid:
mamba2-2.7b, zamba2-7b; dense: mistral-nemo-12b, phi4-mini-3.8b,
stablelm-1.6b), each a copy of the JAX package's config."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, ParallelConfig,
                                     SSMConfig, round_up)
from repro_torch.configs.registry import REGISTRY, get_config

__all__ = ["ModelConfig", "MoEConfig", "ParallelConfig", "REGISTRY",
           "SSMConfig", "get_config", "round_up"]
