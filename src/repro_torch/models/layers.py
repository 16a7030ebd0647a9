"""Shared building blocks: RMSNorm and LayerNorm, RoPE, whisper's
sinusoidal positions, and the MLP of dense layers and shared experts
(port of ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Dict

import math

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Reduction in f32, scaling by ``1 + scale`` in the input dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = (torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)
    return x * inv


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance in f32; the centring, the scaling by
    ``inv * scale`` and the bias in the input dtype, rounded in the JAX
    function's order."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)     # jnp.var's
    inv = torch.rsqrt(var + eps)
    return ((x - mu.to(x.dtype)) * (inv * scale).to(x.dtype)
            + bias.to(x.dtype))


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def init_norm(shape, kind: str, device) -> Dict[str, torch.Tensor]:
    """A norm's f32 parameters of ``shape`` (``(..., d)``): RMSNorm's scale
    at 0 (it scales by ``1 + scale``), LayerNorm's scale at 1 and bias at
    0."""
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    if kind == "rmsnorm":
        return {"scale": zeros}
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": zeros}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  Rotates the
    two halves of each head (not interleaved pairs), in f32."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., :, None, None].float() * freqs        # [.., S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int,
                         device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings [seq_len, d] in f32:
    sines then cosines of ``pos * exp(-i ln(10000) / (d // 2 - 1))`` for
    even i < d, the JAX function's divisor kept as it is."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / (d // 2 - 1)))
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor],
        act: str) -> torch.Tensor:
    """The MLP of a dense layer or of the shared experts: SwiGLU
    (``w_gate``, ``w_in``, ``w_out``), gemma2's gated GELU (``gelu``:
    ``gelu(x @ w_gate) * (x @ w_in)``) or, for ``gelu_mlp`` and
    ``relu_mlp``, GELU or ReLU between two products, with no gate; GELU is
    the tanh form (``jax.nn.gelu``'s default).  Plain ``torch.matmul``
    products, as the JAX package leaves them to XLA."""
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif act == "gelu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    elif act == "gelu_mlp":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu_mlp":
        h = F.relu(h)
    else:
        raise ValueError(act)
    return h @ p["w_out"]
