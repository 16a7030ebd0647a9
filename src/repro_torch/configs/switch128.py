"""switch128 — the paper's own Switch Transformer (T5-style, 128 experts).

12 transformer blocks alternating dense / MoE; 128 experts per MoE block
(top-1 switch routing); expert ~18 MB (paper Table 1).  Copied field for
field from the JAX package.
[arXiv:2101.03961 + HarMoEny Table 1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="switch128",
    family="moe",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32128,
    head_dim=64,
    act="gelu_mlp",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=128,
        num_experts_per_tok=1,     # switch routing: top-1
        d_ff_expert=3072,          # 2*768*3072*4B ≈ 18.9 MB/expert fp32 (paper: 18 MB)
        moe_layer_period=2,        # alternate dense / MoE blocks
        moe_layer_offset=1,
        policy="harmoeny",
        capacity_factor=1.25,
        num_foreign_slots=4,
    ),
    tie_embeddings=True,
    source="paper model; arXiv:2101.03961",
)
