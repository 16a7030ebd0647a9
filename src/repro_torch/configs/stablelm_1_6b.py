"""stablelm-1.6b [dense].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    norm="layernorm",
    act="swiglu",
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
