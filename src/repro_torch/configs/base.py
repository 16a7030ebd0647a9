"""Model / shape / parallelism configuration dataclasses.

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
class SSMConfig:
    state_dim: int = 128       # N (dstate)
    head_dim: int = 64         # P
    num_heads: int = 0         # derived if 0: expand*d_model // head_dim
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256      # SSD chunk length


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

    # --- MoE / SSM sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True iff every sequence-mixing layer is sub-quadratic (SSM,
        hybrid, or a sliding window over every layer), as in JAX: the
        ``long_500k`` cell runs only then."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 and self.global_attn_every == 0

    @property
    def has_decode(self) -> bool:
        return True  # every family decodes (whisper is encoder-decoder)

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
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, num_heads=0, chunk_size=32)
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
            ssm=ssm,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry-run matrix (JAX's: train_4k /
    prefill_32k / decode_32k / long_500k)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, plus the reason when skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""


@dataclass(frozen=True)
class ParallelConfig:
    """The subset of the JAX ``ParallelConfig`` the one-rank port honours.
    ``remat`` other than "none" checkpoints each period of the stack in
    training, "selective" as "full" (JAX's reading); ``microbatch`` n > 1
    splits a training batch into n microbatches (``launch.steps``);
    ``compress_grads`` names JAX's int8 all-reduce (``optim.compress``);
    it is read nowhere, in JAX as here (no data-parallel step uses it).
    ``fsdp`` and ``shard_kv_seq`` are read only by ``launch/shardings``
    and ``launch/dryrun`` (JAX's steps do not read them either): they
    choose the specs, and the port runs no sharded step."""

    fsdp: bool = False            # shard params/opt-state over 'data' too
    remat: str = "none"           # none | full | selective
    shard_kv_seq: bool = False    # long_500k: KV sequence over 'data'
    microbatch: int = 0           # >0: microbatches accumulated in f32
    compress_grads: bool = False  # int8 all-reduce
    loss_chunk: int = 2048        # vocab-loss sequence chunk
    attn_chunk: int = 1024        # chunked attention's KV block in training
    moe_cf_pair: float = 2.0      # off-diagonal dispatch pair capacity factor
    moe_block_m: int = 128        # grouped-FFN row-tile (weight reuse ~ block_m)
