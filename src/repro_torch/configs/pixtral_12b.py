"""pixtral-12b [vlm]: pixtral-ViT frontend (stubbed to patch embeddings) + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="swiglu",
    num_prefix_embeddings=1024,  # stubbed ViT patch embeddings, prepended
    tie_embeddings=False,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
