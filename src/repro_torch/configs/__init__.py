"""The port's model configurations: the dataclasses of ``base`` (models,
shapes, parallelism) and the registry of the archs it builds (MoE:
qwen15-moe-a27b, moonshot-v1-16b-a3b, switch128, mixtral-8x7b; SSM and
hybrid: mamba2-2.7b, zamba2-7b; dense: mistral-nemo-12b, phi4-mini-3.8b,
stablelm-1.6b, gemma2-2b; whisper-large-v3 and pixtral-12b), each a copy
of the JAX package's config, with the dry-run's cell matrix
(``iter_cells``)."""
from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, ModelConfig,
                                     MoEConfig, ParallelConfig, ShapeConfig,
                                     SSMConfig, round_up, shape_applicable)
from repro_torch.configs.registry import (ASSIGNED, PAPER_MODELS, REGISTRY,
                                         get_config, iter_cells)

__all__ = ["ASSIGNED", "ModelConfig", "MoEConfig", "PAPER_MODELS",
           "ParallelConfig", "REGISTRY", "SHAPES", "SHAPE_BY_NAME",
           "SSMConfig", "ShapeConfig", "get_config", "iter_cells",
           "round_up", "shape_applicable"]
