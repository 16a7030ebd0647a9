"""Architecture registry of the port: the models it serves so far."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen15_moe_a27b import CONFIG as _qwen
from repro_torch.configs.switch128 import CONFIG as _switch

REGISTRY: Dict[str, ModelConfig] = {
    "qwen15-moe-a27b": _qwen,
    "moonshot-v1-16b-a3b": _moonshot,
    "switch128": _switch,
    "mixtral-8x7b": _mixtral,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]
