"""mistral-nemo-12b [dense]: 128k ctx.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="swiglu",
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
)
