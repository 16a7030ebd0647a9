"""Model / parallelism configuration dataclasses.

A copy of ``repro/configs/base.py`` trimmed to what the port uses, so the
port never imports the JAX package.  The fields and ``reduced()`` are
kept identical: the parity tests build the same configuration on both
sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """MoE sub-config. ``policy`` selects the scheduling policy of core/."""

    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_ff_expert: int = 0          # per-expert FFN hidden size
    num_shared_experts: int = 0   # dense experts applied to every token
    moe_layer_period: int = 1     # every k-th layer is MoE (1 = all)
    moe_layer_offset: int = 0     # first MoE layer index
    first_dense_layers: int = 0   # leading dense layers (moonshot style)
    policy: str = "harmoeny"      # harmoeny | round_robin | even_split | static_opt
    capacity_factor: float = 1.25
    num_foreign_slots: int = 4    # K extra expert slots per rank (0 for decode)
    num_replica_slots: int = 0
    placement: Optional[Tuple[int, ...]] = None
    q_tokens: int = 0             # 0 = derive from hardware constants (Eq. 4)
    router_skew: float = 0.0      # synthetic skew alpha (paper Sec 5.1.2)
    router_skew_experts: int = 1  # number of "hot" experts for synthetic skew


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # derived if 0: d_model // num_heads

    # --- attention flavour ---
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention
    global_attn_every: int = 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_every: int = 0
    use_qk_norm: bool = False

    # --- MLP / norm ---
    act: str = "swiglu"             # swiglu | gelu | gelu_mlp
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = True
    post_norm: bool = False

    # --- MoE / SSM sub-configs (SSM is not ported: always None here) ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[object] = None

    # --- enc-dec / multimodal ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    num_prefix_embeddings: int = 0

    # --- numerics / source provenance ---
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (same rule as the JAX
        package's ``ModelConfig.reduced``)."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                num_experts_per_tok=min(self.moe.num_experts_per_tok, 2),
                d_ff_expert=64 if self.moe.d_ff_expert else 0,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                num_foreign_slots=2,
            )
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            global_attn_every=self.global_attn_every and 2,
            attn_every=self.attn_every and 2,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 32) if self.encoder_seq_len else 0,
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8)
            if self.num_prefix_embeddings else 0,
            moe=moe,
            dtype="float32",
        )


@dataclass(frozen=True)
class ParallelConfig:
    """The subset of the JAX ``ParallelConfig`` the one-rank port honours."""

    moe_cf_pair: float = 2.0      # off-diagonal dispatch pair capacity factor
    moe_block_m: int = 128        # grouped-FFN row-tile (weight reuse ~ block_m)
