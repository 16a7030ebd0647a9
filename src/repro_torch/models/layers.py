"""Shared building blocks: RMSNorm, RoPE, and the MLP of dense layers and
shared experts (port of ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Reduction in f32, scaling by ``1 + scale`` in the input dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = (torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)
    return x * inv


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"{kind} is not ported yet")
    return rmsnorm(x, p["scale"])


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


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor],
        act: str) -> torch.Tensor:
    """The MLP of a dense layer or of the shared experts: SwiGLU
    (``w_gate``, ``w_in``, ``w_out``) or, for ``gelu_mlp``, tanh-GELU
    between two products (``jax.nn.gelu``'s default).  Plain
    ``torch.matmul`` products, as the JAX package leaves them to XLA."""
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif act == "gelu_mlp":
        h = F.gelu(h, approximate="tanh")
    else:
        raise NotImplementedError(f"{act} MLP is not ported yet")
    return h @ p["w_out"]
