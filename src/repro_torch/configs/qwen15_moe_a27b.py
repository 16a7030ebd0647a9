"""qwen15-moe — the paper's QWEN model (Qwen1.5-MoE, 24 blocks x 60 experts).

Expert ~33 MB (paper Table 1): 3*1408*2048*4B ≈ 34.6 MB fp32.
[hf:Qwen/Qwen1.5-MoE-A2.7B + HarMoEny Table 1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen15-moe-a27b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,
    vocab_size=151936,
    head_dim=128,
    act="swiglu",
    moe=MoEConfig(
        num_experts=60,
        num_experts_per_tok=4,
        d_ff_expert=1408,
        num_shared_experts=4,
        policy="harmoeny",
        capacity_factor=1.25,
        num_foreign_slots=4,
    ),
    tie_embeddings=False,
    source="paper model; hf:Qwen/Qwen1.5-MoE-A2.7B",
)
