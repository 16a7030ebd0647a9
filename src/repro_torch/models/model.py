"""``build_model``: the model API the serve engine and ``launch.steps`` drive.

Port of ``repro/models/model.py`` for decoder-only MoE stacks: MoE
layers after optional leading dense layers (qwen15-moe-a27b,
moonshot-v1-16b-a3b), or periods of dense and MoE layers with SwiGLU or
GELU MLPs (switch128), with full or sliding-window attention
(mixtral-8x7b); for dense decoders, one attention and MLP layer a
period (mistral-nemo-12b, phi4-mini-3.8b with tied embeddings,
stablelm-1.6b with LayerNorm), or gemma2-2b's periods of a local
(windowed) and a global layer, with logit softcaps, post-norms, the gated
GELU and its embedding scale; for the SSM (mamba2-2.7b, tied
embeddings) and hybrid (zamba2-7b: mamba groups around one shared
attention block) families, whose caches hold fixed-size recurrent state
(``transformer.run_hybrid``, ``models/mamba2.py``); and, through
``prefill`` and ``decode_step`` only (the serve engine refuses them, as
JAX's does), whisper-large-v3's encoder-decoder (stubbed frame
embeddings, absolute sinusoidal positions, cross-attention over the
encoder's cached K/V) and pixtral-12b (stubbed patch embeddings before
the tokens).  The returned ``Model`` exposes:
  init(seed)                                   -> params (random, seeded)
  param_shapes()                               -> init's leaves, empty on meta
  prefill(params, batch, s_max, skew_key, kernels)
                                               -> (logits, caches, S, diags)
  prefill_chunk(params, tokens, caches, pos, last_index, skew_key,
                skew_assign, moe_replica_ids, fused_attention)
                                               -> (logits, caches, pos + C, diags)
  decode_step(params, token, caches, pos, skew_key, active_mask, block_table,
              block_size, moe_policy, skew_assign, moe_replica_ids,
              moe_residency_ids, moe_layer_diags, fused_attention, kernels)
                                               -> (logits, caches, pos + S, diags)
  train_loss(params, batch, skew_key)          -> (loss, diags)
  encode(params, frames)                       -> whisper's encoder output
  init_cache(batch, s_max, device, clamp_window)
                                               -> slab K/V caches
  init_paged_cache(num_blocks, block_size, s_ref, seq_axes, clamp_window)
                                               -> the physical paged K/V pool
``train_loss`` is JAX's: the cache-less stack on the plain branches (no
kernel has a backward), each period checkpointed with
``ParallelConfig.remat``, and the chunked cross-entropy
(``losses.chunked_softmax_xent``), plus 0.01 times the MoE blocks' mean
aux loss.  Caches are updated in place.  Everything lives on
``model.device``: CUDA unless the caller passes ``device="cpu"``.  At expert-parallel degree
G > 1 the MoE blocks run G ranks in lockstep on that one device
(``dispatch.VirtualGroup``); expert weights stay rank-major
``[G * epr, ...]``, as the JAX package lays them out.  Given a
``dispatch.DistComm`` of G processes, the model is that process's rank of
a G-way model: its expert leaves hold the rank's own ``[n, epr, ...]``
rows (``convert.shard_params``, or ``init``), everything else is
replicated, and every process runs the whole stack on the same tokens.
With fewer experts than ranks (E < G) the MoE blocks are tensor-parallel
(``MoEBlockSpec.tp_mode``, as JAX's ``build_model`` sets it): each
expert leaf holds ``[G * E, ...]`` rows, row ``g * E + e`` rank g's
contiguous d_ff slice of expert e (``convert.tp_rows``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.dispatch import DistComm, LocalComm, VirtualGroup
from repro_torch.core.moe_layer import MoEBlockSpec
from repro_torch.core.router import SkewKey
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.layers import (init_norm, mlp, norm,
                                       sinusoidal_positions)
from repro_torch.models.mamba2 import init_mamba
from repro_torch.models.losses import chunked_softmax_xent, logits_head

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _normal(shape, scale: float, gen: Optional[torch.Generator], device,
            dtype, keep: Optional[slice] = None) -> torch.Tensor:
    """N(0, scale^2) draws in f32, cast to ``dtype`` a slab at a time so the
    f32 transient stays bounded at full width.  ``keep`` cuts axis 1 of
    each slab once drawn (one EP rank's expert rows): the kept values are
    the whole draw's, and the generator advances as for the whole.  With
    no generator (the meta device) the empty tensor of the kept shape."""
    kept = list(shape)
    if keep is not None:
        kept[1] = len(range(shape[1])[keep])
    out = torch.empty(kept, dtype=dtype, device=device)
    if gen is None:
        return out
    inner = math.prod(shape[1:])
    step = max(1, (1 << 28) // max(inner, 1))
    for i in range(0, shape[0], step):
        rows = min(step, shape[0] - i)
        slab = torch.randn((rows,) + tuple(shape[1:]), generator=gen,
                           device=device)
        if keep is not None:
            slab = slab[:, keep]
        out[i:i + rows] = (slab * scale).to(dtype)
        del slab
    return out


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    moe_spec: Optional[MoEBlockSpec]         # prefill chunks (None: no MoE)
    moe_spec_decode: Optional[MoEBlockSpec]  # decode steps
    comm: Any = None                # the MoE blocks' EP group
    seq_len: int = 0                # build-time length (whisper's positions)
    pcfg: ParallelConfig = ParallelConfig()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters at the JAX init's scales (the two frameworks'
        generators differ: tests convert JAX weights instead, convert.py).
        On a ``DistComm`` rank the expert leaves hold this rank's rows
        only, with exactly the values the rank-major init gives them: each
        leaf is drawn a layer slab at a time and cut as it is drawn."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        d, H, Hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
        Vp = cfg.padded_vocab
        pattern, n, lead = T.layer_pattern(cfg)
        s_d = (2.0 / d) ** 0.5
        own = self.comm.ranks_here if isinstance(self.comm, DistComm) \
            else None

        def nrm(shape, scale, dtype=dt, per_rank=None):
            """``per_rank``: the leaf's rows on axis 1 are expert rows,
            ``per_rank`` a rank (cut to this process's under DistComm)."""
            keep = (None if own is None or per_rank is None else
                    slice(own[0] * per_rank, (own[-1] + 1) * per_rank))
            return _normal(shape, scale, gen, dev, dtype, keep)

        def full(shape, value, dtype):
            out = torch.empty(shape, dtype=dtype or dt, device=dev)
            return out.copy_(torch.as_tensor(value).expand(shape))

        def norm_p(n=()):
            return init_norm(n + (d,), cfg.norm, dev)

        def mamba_layer(n=()):
            return {"mamba": init_mamba(cfg, nrm, full, n),
                    "norm1": norm_p(n)}

        def attn_w(n=()):
            return {"wq": nrm(n + (d, H, hd), s_d),
                    "wk": nrm(n + (d, Hkv, hd), s_d),
                    "wv": nrm(n + (d, Hkv, hd), s_d),
                    "wo": nrm(n + (H, hd, d), s_d)}

        def attn_layer(n=()):
            p = {"norm1": norm_p(n), "norm2": norm_p(n), "attn": attn_w(n)}
            if cfg.post_norm:             # gemma2's norms after each block
                p["post_norm1"] = norm_p(n)
                p["post_norm2"] = norm_p(n)
            return p

        def ffn(n, f):
            """A dense MLP of ``cfg.act``: SwiGLU and the gated GELU carry
            a gate."""
            p = {"w_in": nrm(n + (d, f), s_d),
                 "w_out": nrm(n + (f, d), (2.0 / f) ** 0.5)}
            if cfg.act in ("swiglu", "gelu"):
                p["w_gate"] = nrm(n + (d, f), s_d)
            return p

        def layer(kind, n=n):
            p: Dict[str, Any] = attn_layer((n,))
            if kind != "moe":
                p["mlp"] = ffn((n,), cfg.d_ff)
                return p
            if self.moe_spec.tp_mode:
                p["moe"] = tp_layer()
                if cfg.moe.num_shared_experts:
                    p["shared_mlp"] = ffn(
                        (n,), cfg.moe.num_shared_experts
                        * cfg.moe.d_ff_expert)
                return p
            topo = self.moe_spec.topo
            epr = topo.experts_per_rank
            rows = topo.num_ranks * epr
            f = cfg.moe.d_ff_expert
            p["moe"] = {"router": nrm((n, d, topo.padded_experts), 0.02,
                                      torch.float32),
                        "w_in": nrm((n, rows, d, f), s_d, per_rank=epr),
                        "w_out": nrm((n, rows, f, d), (2.0 / f) ** 0.5,
                                     per_rank=epr)}
            if self.moe_spec.act == "silu":    # gated experts
                p["moe"]["w_gate"] = nrm((n, rows, d, f), s_d,
                                         per_rank=epr)
            R = cfg.moe.num_replica_slots
            if R:
                # replica slots start empty (ids -1, never scheduled);
                # serve/rebalance.py copies hot experts' rows into them
                ranks = topo.num_ranks if own is None else len(own)
                for name in ("in", "out", "gate"):
                    if f"w_{name}" in p["moe"]:
                        p["moe"][f"w_rep_{name}"] = torch.zeros(
                            (n, ranks * R)
                            + tuple(p["moe"][f"w_{name}"].shape[2:]),
                            dtype=dt, device=dev)
            if cfg.moe.num_shared_experts:
                p["shared_mlp"] = ffn((n,), cfg.moe.num_shared_experts * f)
            return p

        def tp_layer():
            """Tensor-parallel experts: the values a one-rank init draws,
            each rank's d_ff slice made contiguous (``convert.tp_rows``),
            and the router over the E real experts."""
            from repro_torch.convert import tp_rows
            G, E, f = self.moe_spec.ep_degree, cfg.moe.num_experts, \
                cfg.moe.d_ff_expert
            moe = {"router": nrm((n, d, E), 0.02, torch.float32)}
            for name, shape, scale in (
                    ("w_in", (n, E, d, f), s_d),
                    ("w_out", (n, E, f, d), (2.0 / f) ** 0.5),
                    ("w_gate", (n, E, d, f), s_d)):
                if name == "w_gate" and self.moe_spec.act != "silu":
                    continue
                w = tp_rows(nrm(shape, scale), G, name)
                if own is not None:
                    w = w.narrow(1, own[0] * E, len(own) * E).clone()
                moe[name] = w
            return moe

        if cfg.family == "hybrid":
            per, n_groups, rem = T.hybrid_shape(cfg)
            stack: Dict[str, Any] = {
                "groups": mamba_layer((n_groups, per)),
                "shared": {**attn_layer(), "mlp": ffn((), cfg.d_ff)}}
            if rem:
                stack["tail"] = [mamba_layer() for _ in range(rem)]
        else:
            stack = {"blocks": {f"sub{j}": (mamba_layer((n,))
                                            if kind == "mamba"
                                            else layer(kind))
                                for j, kind in enumerate(pattern)}}
        params: Dict[str, Any] = {
            "embed": nrm((Vp, d), 0.02),
            "final_norm": norm_p(),
            "stack": stack,
        }
        if lead:
            params["stack"]["lead"] = [
                {**attn_layer(), "mlp": ffn((), cfg.d_ff)}
                for _ in range(lead)]
        if not cfg.tie_embeddings:
            params["lm_head"] = nrm((Vp, d), 0.02)
        if cfg.is_encoder_decoder:
            L = cfg.num_layers
            params["encoder"] = {
                "stack": {"blocks": {"sub0": layer(
                    "dense", n=cfg.encoder_layers)}},
                "final_norm": norm_p()}
            params["cross"] = {"norm": norm_p((L,)), "attn": attn_w((L,))}
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """``init``'s tree with every leaf an empty ``meta`` tensor of its
        shape and dtype, in its order (replica and tensor-parallel leaves
        included): the counterpart of ``jax.eval_shape(model.init)``.
        Nothing is drawn or allocated, so a full-width model's tree costs
        nothing (``launch/dryrun.py``)."""
        return dataclasses.replace(self, device=torch.device("meta")).init()

    def init_cache(self, b: int, s_max: int, device=None,
                   clamp_window: bool = True) -> Dict[str, Any]:
        """Slab K/V caches on ``model.device``, or on ``device`` when given
        (the serve engine probes leaf shapes on the ``meta`` device).  A
        sliding-window model's leaves hold min(s_max, window) positions
        unless ``clamp_window`` is False.  The SSM and hybrid families'
        recurrent state is f32 and fixed-size; the hybrid's attention
        caches are never clamped."""
        dev = device or self.device
        cfg = self.cfg
        if cfg.family == "hybrid":
            return {"stack": T.init_hybrid_cache(cfg, b, s_max,
                                                 self.dtype, dev)}
        cache = {"stack": T.init_stack_cache(cfg, b, s_max, self.dtype,
                                             dev, clamp_window)}
        if cfg.is_encoder_decoder:
            # the encoder's K/V for every decoder layer, filled by prefill
            shape = (cfg.num_layers, b, cfg.encoder_seq_len,
                     cfg.num_kv_heads, cfg.resolved_head_dim)
            cache["cross"] = A.AttnCache(
                torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev))
        return cache

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         s_ref: Optional[int] = None,
                         seq_axes: Any = None,
                         clamp_window: bool = True) -> Dict[str, Any]:
        """A batch-1 physical pool: each leaf of ``init_cache(1, s_ref)``
        (``s_ref`` default: one block) with its KV-length axis resized to
        ``num_blocks * block_size`` positions, addressed through block
        tables.  ``seq_axes`` skips re-discovery when the caller (the
        serve engine) holds them; ``clamp_window=False`` builds the pool
        over unclamped leaves (the serve engine's sliding-window rings)."""
        from repro_torch.serve.paging import make_paged_pool
        from repro_torch.serve.slots import discover_seq_axes
        s = s_ref or block_size

        def ic(b, s_max, device=None):
            return self.init_cache(b, s_max, device, clamp_window)
        if seq_axes is None:
            seq_axes = discover_seq_axes(ic, s)
        return make_paged_pool(ic, s, seq_axes, num_blocks, block_size,
                               device=self.device)

    # ------------------------------------------------------------------
    def _backbone(self, params, h, *, cache, cache_len, q_offset=0,
                  moe_spec=None, continue_prefill: bool = False,
                  valid_mask=None, cross=None, kernels: bool = True,
                  train: bool = False, **kw):
        """The stack of ``cfg.family`` on h [B, S, d]: ``run_hybrid`` or
        whisper's decoder over the encoder's K/V ``cross`` (neither on a
        paged pool: JAX's refusal), or ``run_stack`` with every
        keyword.  ``train``: no cache, the plain branches, and the
        ``ParallelConfig``'s remat and attention chunk."""
        cfg = self.cfg
        if (cfg.family == "hybrid" or cfg.is_encoder_decoder) \
                and kw.get("block_table") is not None:
            raise NotImplementedError(
                "paged KV decode supports plain decoder stacks only")
        tr = {}
        if train:
            kernels = False
            tr = dict(remat=self.pcfg.remat != "none",
                      attn_chunk=self.pcfg.attn_chunk)
        if cfg.family == "hybrid":
            return T.run_hybrid(h, params["stack"], cfg, cache=cache,
                                cache_len=cache_len, q_offset=q_offset,
                                continue_prefill=continue_prefill,
                                valid_mask=valid_mask, **tr)
        if cfg.is_encoder_decoder:
            return _run_encdec_decoder(h, params, cfg, cache=cache,
                                       cache_len=cache_len,
                                       q_offset=q_offset, cross=cross,
                                       kernels=kernels, **tr)
        return T.run_stack(h, params["stack"], cfg, cache=cache,
                           cache_len=cache_len, q_offset=q_offset,
                           moe_spec=moe_spec, comm=self.comm,
                           continue_prefill=continue_prefill,
                           valid_mask=valid_mask, kernels=kernels, **tr,
                           **kw)

    def _embed_tokens(self, params, tokens, offset=0):
        """Token embeddings, plus whisper's absolute sinusoidal positions
        (no RoPE) at ``offset`` (an int, a 0-d tensor or one per row), or
        times gemma's ``d ** 0.5``, cast to h's dtype first, as in JAX.
        The position table has the build-time ``seq_len + 65`` rows, and an
        offset past it is clamped as JAX's slice and gather clamp: a
        scalar offset's window starts at most ``len - S``, a per-row
        offset's every index is clamped to the last row."""
        cfg = self.cfg
        h = params["embed"][tokens]
        if cfg.rope_theta <= 0 and cfg.ssm is None:
            n = self.seq_len + 65
            table = sinusoidal_positions(n, cfg.d_model, h.device).to(h.dtype)
            S = tokens.shape[1]
            ar = torch.arange(S, device=h.device)
            off = torch.as_tensor(offset, device=h.device)
            if off.ndim:
                h = h + table[(off.reshape(-1, 1).long() + ar).clamp(
                    0, n - 1)]
            else:
                h = h + table[off.long().clamp(0, n - S) + ar][None]
        if cfg.name.startswith("gemma"):
            # a host scalar, so that a captured step copies nothing
            h = h * float(torch.tensor(cfg.d_model ** 0.5).to(h.dtype))
        return h

    def encode(self, params, frames: torch.Tensor,
               attn_chunk: int = 1024) -> torch.Tensor:
        """Whisper's encoder over stubbed frame embeddings [B, S_enc, d]:
        sinusoidal positions, ``encoder_layers`` layers of full
        (non-causal) attention, plain as in JAX (KV blocks of
        ``attn_chunk``), and the encoder's final norm."""
        cfg = self.cfg
        enc_cfg = cfg.replace(num_layers=cfg.encoder_layers,
                              is_encoder_decoder=False)
        frames = torch.as_tensor(frames, device=self.device)
        pos = sinusoidal_positions(frames.shape[1], cfg.d_model,
                                   frames.device).to(frames.dtype)
        h, _, _ = T.run_stack(frames + pos[None], params["encoder"]["stack"],
                              enc_cfg, cache=None, moe_spec=None,
                              causal=False, kernels=False,
                              attn_chunk=attn_chunk)
        return norm(h, params["encoder"]["final_norm"], cfg.norm)

    def _vocab_w(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["lm_head"]

    def _head(self, params, h_last):
        h_last = norm(h_last, params["final_norm"], self.cfg.norm)
        return logits_head(h_last, self._vocab_w(params),
                           real_vocab=self.cfg.vocab_size,
                           softcap=self.cfg.final_logit_softcap)

    def train_loss(self, params, batch: Dict[str, Any],
                   skew_key: Optional[SkewKey] = None, *,
                   skew_assign: Optional[torch.Tensor] = None,
                   moe_layer_diags: bool = False):
        """JAX's ``train_loss``: the mean next-token NLL of
        ``batch["labels"]`` [B, S] (-1 ignored) after ``batch["tokens"]``
        [B, S], through the cache-less stack on the plain branches (with
        the ``ParallelConfig``'s remat) and the chunked cross-entropy of
        ``loss_chunk`` positions.  Whisper encodes ``batch["frames"]``
        first; pixtral puts ``batch["patches"]`` before the tokens and
        cuts them after the stack.  The MoE blocks run with the training
        spec (``tokens_local`` of one microbatch) on ``skew_key``'s skew
        where the config has one, or on ``skew_assign`` drawn beforehand
        (``transformer.run_stack``), and ``0.01 * aux_loss`` is added, as
        in JAX; ``moe_layer_diags`` adds ``expert_load_layers``.  Returns
        (loss, diags), both f32 on ``model.device``."""
        cfg, pc = self.cfg, self.pcfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        h = self._embed_tokens(params, tokens)
        cross = None
        if cfg.is_encoder_decoder:
            enc = self.encode(params, batch["frames"], pc.attn_chunk)
            cross = _cross_kv(params, enc)
        n_prefix = cfg.num_prefix_embeddings
        if n_prefix:
            patches = torch.as_tensor(batch["patches"], device=self.device)
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        h, _, diags = self._backbone(params, h, cache=None, cache_len=None,
                                     moe_spec=self.moe_spec,
                                     skew_key=skew_key, cross=cross,
                                     train=True, skew_assign=skew_assign,
                                     moe_layer_diags=moe_layer_diags)
        h = norm(h, params["final_norm"], cfg.norm)
        if n_prefix:
            h = h[:, n_prefix:]
        loss = chunked_softmax_xent(
            h, self._vocab_w(params), labels, real_vocab=cfg.vocab_size,
            chunk=pc.loss_chunk, softcap=cfg.final_logit_softcap)
        if "aux_loss" in diags:
            loss = loss + 0.01 * diags["aux_loss"]
        return loss, diags

    def prefill(self, params, batch: Dict[str, Any],
                s_max: Optional[int] = None,
                skew_key: Optional[SkewKey] = None, kernels: bool = True):
        """A whole prompt ``batch["tokens"]`` [B, S] on a fresh slab cache
        of ``s_max`` positions (default S + 64, the tokens' count, as in
        JAX): attention through the flash kernel (``chunked_attention``
        under a sliding window or a softcap), K/V into the cache prefix
        [0, S) (a window-clamped cache keeps the window's tail at its ring
        slots).  Whisper encodes ``batch["frames"]`` [B, S_enc, d] first
        and keeps each decoder layer's cross K/V in ``caches["cross"]``;
        pixtral puts ``batch["patches"]`` [B, n_prefix, d] before the
        tokens.  Returns (logits [B, Vp] at the last position, caches,
        pos = the positions filled as a 0-d int32 tensor, diags).  Runs
        with the build-time MoE spec; ``kernels`` False takes the plain
        attention branches on every device."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        caches = self.init_cache(B, s_max or S + 64)
        h = self._embed_tokens(params, tokens)
        cross = None
        if cfg.is_encoder_decoder:
            cross = _cross_kv(params, self.encode(params, batch["frames"]))
            caches["cross"] = cross
        if cfg.num_prefix_embeddings:
            patches = torch.as_tensor(batch["patches"], device=self.device)
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        pos = torch.tensor(h.shape[1], dtype=torch.int32, device=self.device)
        h, _, diags = self._backbone(params, h, cache=caches["stack"],
                                     cache_len=pos, moe_spec=self.moe_spec,
                                     skew_key=skew_key, cross=cross,
                                     kernels=kernels)
        return self._head(params, h[:, -1]), caches, pos, diags

    def prefill_chunk(self, params, tokens: torch.Tensor, caches, pos,
                      last_index=None, skew_key: Optional[SkewKey] = None,
                      skew_assign: Optional[torch.Tensor] = None,
                      moe_replica_ids: Optional[torch.Tensor] = None,
                      fused_attention: Optional[bool] = None):
        """Chunked-prefill continuation: tokens [Bc, C] appended to the slab
        ``caches`` at position ``pos`` (all rows share it).  Logits at
        ``last_index`` (default C - 1); pad tokens past it are kept out of
        MoE routing and capacity.  ``pos`` and ``last_index`` are ints or
        0-d device tensors; with tensors (and ``skew_assign``
        [n_moe_layers, n, t_slice, k] in place of the skew key, as in
        ``decode_step``) the chunk reads no host value, so the serve
        engine's captured chunk replays at any position.
        ``moe_replica_ids`` [G, R] names the experts in the replica slots
        (``moe_layer.moe_block``).  ``fused_attention`` (the serve
        engine's ``fused_paged_attention``) makes the chunk strict: a
        branch without a kernel raises ``FusedPathUnavailable``."""
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{self.cfg.name}: the encoder-decoder decoder takes whole "
                f"prompts (model.prefill), as in JAX")
        Bc, C = tokens.shape
        G = self.moe_spec.ep_degree if self.moe_spec is not None else 1
        spec = (None if self.moe_spec is None else
                dataclasses.replace(self.moe_spec, tokens_local=Bc * C,
                                    seq_sharded=C % G == 0 and G > 1))
        vmask = None
        if last_index is not None:
            last = torch.as_tensor(last_index, device=self.device).reshape(1)
            vmask = (torch.arange(C, device=self.device)[None, :]
                     <= last).expand(Bc, C)
        h = self._embed_tokens(params, tokens, pos)
        h, stack, diags = self._backbone(
            params, h, cache=caches["stack"], cache_len=pos + C,
            q_offset=pos, moe_spec=spec, skew_key=skew_key,
            continue_prefill=True, valid_mask=vmask,
            skew_assign=skew_assign, moe_replica_ids=moe_replica_ids,
            strict=bool(fused_attention))
        h_last = (h[:, -1] if last_index is None
                  else h.index_select(1, last.long())[:, 0])
        return self._head(params, h_last), caches, pos + C, diags

    def decode_step(self, params, token: torch.Tensor, caches, pos, *,
                    skew_key: Optional[SkewKey] = None, active_mask=None,
                    block_table: Optional[torch.Tensor] = None,
                    block_size: int = 0, moe_policy: Optional[str] = None,
                    skew_assign: Optional[torch.Tensor] = None,
                    moe_replica_ids: Optional[torch.Tensor] = None,
                    moe_residency_ids: Optional[torch.Tensor] = None,
                    moe_layer_diags: bool = False,
                    fused_attention: Optional[bool] = None,
                    kernels: bool = True):
        """token [B, S] against the paged pool (``block_table`` given; S > 1
        is a multi-query window) or, with S = 1, the slab caches of
        ``init_cache`` / ``prefill``.  pos is each row's length BEFORE the
        window: [B], or a scalar on the slab.  ``moe_policy`` overrides the
        decode spec's scheduling policy (and its foreign slots) for this
        step.  ``skew_assign`` [n_moe_layers, n, t_slice, k] replaces the
        skew key's draws with ones made beforehand, one row for each rank
        this process runs (``run_stack``): the serve engine's captured
        step reads no generator.
        ``moe_replica_ids`` [G, R] (-1 = empty) names the experts in the
        replica slots, ``moe_residency_ids`` [G, W] (-1 pads) each rank's
        resident working set (``moe_layer.moe_block``); ``moe_layer_diags``
        adds ``expert_load_layers`` to the diagnostics
        (``transformer.run_stack``); ``fused_attention`` makes a paged
        step strict, as in ``prefill_chunk``; ``kernels`` False takes the
        plain attention and MoE branches on every device, as ``prefill``
        does.  Reads no device value on the host.  Returns logits [B, Vp] at the last position when
        S == 1, else [B, S, Vp]."""
        B, S = token.shape
        if S > 1 and block_table is None:
            raise NotImplementedError(
                "multi-token decode goes through the paged pool: pass "
                "block_table/block_size")
        new_pos = pos + S
        vmask = None
        if active_mask is not None and self.cfg.is_moe:
            vmask = active_mask.reshape(-1, 1).expand(B, S)
        spec = self.moe_spec_decode
        if spec is not None and moe_policy is not None \
                and moe_policy != spec.moe.policy:
            spec = dataclasses.replace(spec, moe=dataclasses.replace(
                spec.moe, policy=moe_policy,
                num_foreign_slots=_decode_foreign_slots(spec, moe_policy)))
        if S > 1 and spec is not None:
            spec = dataclasses.replace(spec, tokens_local=spec.tokens_local * S)
        h = self._embed_tokens(params, token, pos)
        h, stack, diags = self._backbone(
            params, h, cache=caches["stack"], cache_len=new_pos,
            q_offset=pos, moe_spec=spec, skew_key=skew_key,
            cross=caches.get("cross"),
            valid_mask=vmask, block_table=block_table,
            block_size=block_size, skew_assign=skew_assign,
            moe_replica_ids=moe_replica_ids,
            moe_residency_ids=moe_residency_ids,
            moe_layer_diags=moe_layer_diags, kernels=kernels,
            strict=bool(fused_attention) and block_table is not None)
        if S == 1:
            logits = self._head(params, h[:, -1])
        else:
            logits = self._head(params, h.reshape(B * S, -1)).reshape(B, S, -1)
        return logits, caches, new_pos, diags


def _decode_foreign_slots(spec: MoEBlockSpec, policy: str) -> int:
    """Foreign slots at decode: even_split lands every non-local expert,
    harmoeny keeps the configured K, the static policies need none;
    tensor-parallel MoE fetches nothing."""
    if spec.tp_mode:
        return 0
    topo = spec.topo
    if policy == "even_split":
        return topo.padded_experts - topo.experts_per_rank
    if policy == "harmoeny":
        return spec.moe.num_foreign_slots
    return 0


def build_model(cfg: ModelConfig, pcfg: ParallelConfig = ParallelConfig(), *,
                batch: int, seq_len: int, device=None,
                ep_degree: int = 1, comm=None) -> Model:
    """The port's model for a decoder-only MoE, dense, SSM or hybrid
    ``cfg`` at expert-parallel degree ``ep_degree``: G ranks on the one
    device when G > 1 (``VirtualGroup``), or, given ``comm`` (a
    ``DistComm`` of G processes), this process's rank; with fewer experts
    than ranks the MoE blocks are tensor-parallel (``tp_mode``).
    ``device`` defaults to CUDA and raises when no GPU is present."""
    dev = resolve_device(device)
    if comm is not None and comm.size != ep_degree:
        raise ValueError(f"a communicator of {comm.size} ranks for EP "
                         f"degree {ep_degree}")
    if cfg.family not in ("moe", "dense", "ssm", "hybrid", "audio", "vlm") \
            or (cfg.family == "moe") != cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not "
                                  f"ported yet")
    if cfg.act not in ("swiglu", "gelu", "gelu_mlp", "relu_mlp"):
        raise ValueError(f"{cfg.name}: unknown MLP activation {cfg.act!r}")
    moe_spec = moe_spec_decode = None
    if cfg.is_moe:
        moe_spec = MoEBlockSpec(
            moe=cfg.moe, d_model=cfg.d_model, ep_degree=ep_degree,
            # per-step tokens: microbatching divides the batch a step
            tokens_local=max(batch // max(pcfg.microbatch, 1), 1) * seq_len,
            act="silu" if cfg.act == "swiglu" else "gelu",
            cf_pair=pcfg.moe_cf_pair, block_m=pcfg.moe_block_m,
            tp_mode=cfg.moe.num_experts < ep_degree,
            seq_sharded=seq_len % ep_degree == 0 and ep_degree > 1)
        # decode: one token per sequence, 128-row tiles, K per policy
        moe_spec_decode = dataclasses.replace(
            moe_spec, tokens_local=batch, block_m=128, seq_sharded=False,
            moe=dataclasses.replace(cfg.moe, num_foreign_slots=(
                _decode_foreign_slots(moe_spec, cfg.moe.policy))))
    if comm is None:
        comm = (LocalComm() if ep_degree == 1
                else VirtualGroup(ep_degree, dev))
    return Model(cfg=cfg, device=dev, moe_spec=moe_spec,
                 moe_spec_decode=moe_spec_decode, comm=comm, seq_len=seq_len,
                 pcfg=pcfg)


# ----------------------------------------------------------------------
# whisper's decoder: self-attention, cross-attention, MLP a layer
# ----------------------------------------------------------------------
def _cross_kv(params, enc_out: torch.Tensor) -> A.AttnCache:
    """Every decoder layer's cross K/V over the encoder's output, stacked
    [L, B, S_enc, Hkv, hd]: computed once, at prefill."""
    w = params["cross"]["attn"]
    return A.AttnCache(torch.einsum("bsd,ldhk->lbshk", enc_out, w["wk"]),
                       torch.einsum("bsd,ldhk->lbshk", enc_out, w["wv"]))


def _run_encdec_decoder(h, params, cfg: ModelConfig, *, cache, cache_len,
                        q_offset, cross: A.AttnCache, kernels: bool = True,
                        remat: bool = False, attn_chunk: int = 1024):
    """Whisper's decoder stack (JAX's ``_run_encdec_decoder``): each layer's
    causal self-attention over its slab cache (the flash kernel on a
    whole prompt where ``kernels``, plain slab decode; without a cache,
    training, plain over the layer's own K/V in ``attn_chunk`` blocks),
    then its cross-attention over the encoder K/V ``cross`` (plain, as in
    JAX), then the MLP; ``remat`` checkpoints each layer.  Returns
    (h, cache, {})."""
    blocks = params["stack"]["blocks"]["sub0"]

    def layer(h, i):
        p = T.layer_slice(blocks, i)
        pc = T.layer_slice(params["cross"], i)
        y, _ = A.attention_block(
            norm(h, p["norm1"], cfg.norm), p["attn"], cfg,
            q_offset=q_offset,
            cache=(None if cache is None
                   else T.layer_slice(cache["blocks"]["sub0"], i)),
            cache_len=cache_len, kernels=kernels, attn_chunk=attn_chunk)
        h = h + y
        h = h + A.cross_attention(norm(h, pc["norm"], cfg.norm), pc["attn"],
                                  T.layer_slice(cross, i), attn_chunk)
        return h + mlp(norm(h, p["norm2"], cfg.norm), p["mlp"], cfg.act)

    for i in range(cfg.num_layers):
        h = (checkpoint(layer, h, i, use_reentrant=False) if remat
             else layer(h, i))
    return h, cache, {}
