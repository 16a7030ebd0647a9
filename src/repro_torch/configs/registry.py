"""Architecture registry of the port: every arch it builds, the assigned
ten and the paper's two, and the dry-run's cell matrix."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, SHAPES, shape_applicable
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

# The ten assigned architectures, in JAX's order (the dry-run matrix
# iterates these).
ASSIGNED: Dict[str, ModelConfig] = {
    "whisper-large-v3": _whisper,
    "zamba2-7b": _zamba2,
    "gemma2-2b": _gemma2,
    "mistral-nemo-12b": _nemo,
    "phi4-mini-3.8b": _phi4,
    "stablelm-1.6b": _stablelm,
    "moonshot-v1-16b-a3b": _moonshot,
    "mixtral-8x7b": _mixtral,
    "mamba2-2.7b": _mamba2,
    "pixtral-12b": _pixtral,
}

# The paper's own models.
PAPER_MODELS: Dict[str, ModelConfig] = {
    "switch128": _switch,
    "qwen15-moe-a27b": _qwen,
}

# Every arch the port builds.  The serve engine refuses whisper-large-v3
# and pixtral-12b, as JAX's does: they run through model.prefill and
# decode_step.
REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def iter_cells(include_skipped: bool = False):
    """Yield (arch, shape, runnable, skip_reason) over the 10 x 4
    assignment matrix."""
    for arch, cfg in ASSIGNED.items():
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why
