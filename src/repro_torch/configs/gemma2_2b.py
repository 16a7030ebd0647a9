"""gemma2-2b [dense]: local+global alternating attention, logit softcap.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    global_attn_every=2,          # alternate local / global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",                   # geglu
    post_norm=True,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
