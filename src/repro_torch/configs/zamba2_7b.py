"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]

Copied from the JAX package as it stands: one attention(+MLP) block with
shared weights after every 6 mamba layers (13 groups), then 3 mamba
layers of tail.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    attn_every=6,  # a shared-weight attention(+MLP) block every 6 mamba layers
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    act="swiglu",
    source="arXiv:2411.15242; unverified",
)
