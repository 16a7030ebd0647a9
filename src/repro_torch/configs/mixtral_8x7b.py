"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
[arXiv:2401.04088; hf]

Copied from the JAX package as it stands: every layer attends through a
window of 4096 positions (64 in ``reduced()``), which the serve engine
keeps as ring buffers (``serve/kvstore.py``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    sliding_window=4096,  # all layers SWA => sub-quadratic, long_500k runs
    act="swiglu",
    moe=MoEConfig(
        num_experts=8,
        num_experts_per_tok=2,
        d_ff_expert=14336,
        policy="harmoeny",
        capacity_factor=1.25,
        num_foreign_slots=2,
    ),
    tie_embeddings=False,
    source="arXiv:2401.04088; hf",
)
