"""Architecture registry of the port: the models it builds so far."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.qwen15_moe_a27b import CONFIG as _qwen
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.switch128 import CONFIG as _switch
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

REGISTRY: Dict[str, ModelConfig] = {
    "qwen15-moe-a27b": _qwen,
    "moonshot-v1-16b-a3b": _moonshot,
    "switch128": _switch,
    "mixtral-8x7b": _mixtral,
    "mamba2-2.7b": _mamba2,
    "zamba2-7b": _zamba2,
    "mistral-nemo-12b": _nemo,
    "phi4-mini-3.8b": _phi4,
    "stablelm-1.6b": _stablelm,
    "gemma2-2b": _gemma2,
    # built and run through model.prefill / decode_step; the serve engine
    # refuses both, as JAX's does
    "whisper-large-v3": _whisper,
    "pixtral-12b": _pixtral,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]
