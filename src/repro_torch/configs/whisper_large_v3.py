"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed to frame embeddings.

32L (decoder) d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    act="gelu_mlp",
    norm="layernorm",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, no RoPE
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq_len=1500,   # 30 s of audio at 50 Hz after the (stubbed) conv frontend
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
