"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Copied from the JAX package as it stands.  It is not the published
Moonlight-16B-A3B, which has 27 layers and MLA attention: this config has
48 layers of 16 x 128 MHA (about 28.4 B parameters).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,  # dense d_ff for the leading dense layer (moonlight style)
    vocab_size=163840,
    head_dim=128,
    act="swiglu",
    moe=MoEConfig(
        num_experts=64,
        num_experts_per_tok=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_dense_layers=1,
        policy="harmoeny",
        capacity_factor=1.25,
        num_foreign_slots=4,
    ),
    tie_embeddings=False,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
