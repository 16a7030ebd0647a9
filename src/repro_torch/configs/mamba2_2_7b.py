"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060; unverified]

Copied from the JAX package as it stands.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,       # attention-free
    num_kv_heads=0,
    d_ff=0,            # no MLP: mamba2 blocks only
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
