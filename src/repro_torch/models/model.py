"""``build_model``: the model API the serve engine and ``launch.steps`` drive.

Port of ``repro/models/model.py`` for decoder-only MoE stacks: MoE
layers after optional leading dense layers (qwen15-moe-a27b,
moonshot-v1-16b-a3b), or periods of dense and MoE layers with SwiGLU or
GELU MLPs (switch128), with full or sliding-window attention
(mixtral-8x7b).  The returned ``Model`` exposes:
  init(seed)                                   -> params (random, seeded)
  prefill(params, batch, s_max, skew_key)      -> (logits, caches, S, diags)
  prefill_chunk(params, tokens, caches, pos, last_index, skew_key,
                skew_assign, moe_replica_ids, fused_attention)
                                               -> (logits, caches, pos + C, diags)
  decode_step(params, token, caches, pos, skew_key, active_mask, block_table,
              block_size, moe_policy, skew_assign, moe_replica_ids,
              moe_residency_ids, moe_layer_diags, fused_attention)
                                               -> (logits, caches, pos + S, diags)
  init_cache(batch, s_max, device, clamp_window)
                                               -> slab K/V caches
  init_paged_cache(num_blocks, block_size, s_ref, seq_axes, clamp_window)
                                               -> the physical paged K/V pool
Caches are updated in place.  Everything lives on ``model.device``: CUDA
unless the caller passes ``device="cpu"``.  At expert-parallel degree
G > 1 the MoE blocks run G ranks in lockstep on that one device
(``dispatch.VirtualGroup``); expert weights stay rank-major
``[G * epr, ...]``, as the JAX package lays them out.  Given a
``dispatch.DistComm`` of G processes, the model is that process's rank of
a G-way model: its expert leaves hold the rank's own ``[n, epr, ...]``
rows (``convert.shard_params``, or ``init``), everything else is
replicated, and every process runs the whole stack on the same tokens.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.dispatch import DistComm, LocalComm, VirtualGroup
from repro_torch.core.moe_layer import MoEBlockSpec
from repro_torch.core.router import SkewKey
from repro_torch.models import transformer as T
from repro_torch.models.layers import norm
from repro_torch.models.losses import logits_head

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _normal(shape, scale: float, gen: torch.Generator, device,
            dtype, keep: Optional[slice] = None) -> torch.Tensor:
    """N(0, scale^2) draws in f32, cast to ``dtype`` a slab at a time so the
    f32 transient stays bounded at full width.  ``keep`` cuts axis 1 of
    each slab once drawn (one EP rank's expert rows): the kept values are
    the whole draw's, and the generator advances as for the whole."""
    kept = list(shape)
    if keep is not None:
        kept[1] = len(range(shape[1])[keep])
    out = torch.empty(kept, dtype=dtype, device=device)
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
    moe_spec: MoEBlockSpec          # prefill chunks (tokens_local per call)
    moe_spec_decode: MoEBlockSpec   # decode steps
    comm: Any = None                # the MoE blocks' EP group

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
        gen = torch.Generator(device=dev).manual_seed(seed)
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

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def attn_layer(n=()):
            return {"norm1": {"scale": zeros(n + (d,))},
                    "norm2": {"scale": zeros(n + (d,))},
                    "attn": {"wq": nrm(n + (d, H, hd), s_d),
                             "wk": nrm(n + (d, Hkv, hd), s_d),
                             "wv": nrm(n + (d, Hkv, hd), s_d),
                             "wo": nrm(n + (H, hd, d), s_d)}}

        def ffn(n, f):
            """A dense MLP of ``cfg.act``: SwiGLU carries a gate."""
            p = {"w_in": nrm(n + (d, f), s_d),
                 "w_out": nrm(n + (f, d), (2.0 / f) ** 0.5)}
            if cfg.act == "swiglu":
                p["w_gate"] = nrm(n + (d, f), s_d)
            return p

        def layer(kind):
            p: Dict[str, Any] = attn_layer((n,))
            if kind == "dense":
                p["mlp"] = ffn((n,), cfg.d_ff)
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

        params: Dict[str, Any] = {
            "embed": nrm((Vp, d), 0.02),
            "final_norm": {"scale": zeros((d,))},
            "stack": {"blocks": {f"sub{j}": layer(kind)
                                 for j, kind in enumerate(pattern)}},
        }
        if lead:
            params["stack"]["lead"] = [
                {**attn_layer(), "mlp": ffn((), cfg.d_ff)}
                for _ in range(lead)]
        if not cfg.tie_embeddings:
            params["lm_head"] = nrm((Vp, d), 0.02)
        return params

    def init_cache(self, b: int, s_max: int, device=None,
                   clamp_window: bool = True) -> Dict[str, Any]:
        """Slab K/V caches on ``model.device``, or on ``device`` when given
        (the serve engine probes leaf shapes on the ``meta`` device).  A
        sliding-window model's leaves hold min(s_max, window) positions
        unless ``clamp_window`` is False."""
        return {"stack": T.init_stack_cache(self.cfg, b, s_max, self.dtype,
                                            device or self.device,
                                            clamp_window)}

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
    def _vocab_w(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["lm_head"]

    def _head(self, params, h_last):
        h_last = norm(h_last, params["final_norm"], self.cfg.norm)
        return logits_head(h_last, self._vocab_w(params),
                           real_vocab=self.cfg.vocab_size,
                           softcap=self.cfg.final_logit_softcap)

    def prefill(self, params, batch: Dict[str, Any],
                s_max: Optional[int] = None,
                skew_key: Optional[SkewKey] = None):
        """A whole prompt ``batch["tokens"]`` [B, S] on a fresh slab cache
        of ``s_max`` positions (default S + 64): attention through the
        flash kernel (``chunked_attention`` under a sliding window), K/V
        into the cache prefix [0, S) (a window-clamped cache keeps the
        window's tail at its ring slots).  Returns (logits
        [B, Vp] at the last position, caches, pos = S as a 0-d int32
        tensor, diags).  Runs with the build-time MoE spec."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        caches = self.init_cache(B, s_max or S + 64)
        pos = torch.tensor(S, dtype=torch.int32, device=self.device)
        h = params["embed"][tokens]
        h, _, diags = T.run_stack(h, params["stack"], self.cfg,
                                  cache=caches["stack"], cache_len=pos,
                                  moe_spec=self.moe_spec, comm=self.comm,
                                  skew_key=skew_key)
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
        Bc, C = tokens.shape
        spec = dataclasses.replace(self.moe_spec, tokens_local=Bc * C)
        vmask = None
        if last_index is not None:
            last = torch.as_tensor(last_index, device=self.device).reshape(1)
            vmask = (torch.arange(C, device=self.device)[None, :]
                     <= last).expand(Bc, C)
        h = params["embed"][tokens]
        h, stack, diags = T.run_stack(
            h, params["stack"], self.cfg, cache=caches["stack"],
            cache_len=pos + C, q_offset=pos, moe_spec=spec, comm=self.comm,
            skew_key=skew_key, continue_prefill=True, valid_mask=vmask,
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
                    fused_attention: Optional[bool] = None):
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
        step strict, as in ``prefill_chunk``.  Reads no device value on
        the host.  Returns logits [B, Vp] at the last position when
        S == 1, else [B, S, Vp]."""
        B, S = token.shape
        if S > 1 and block_table is None:
            raise NotImplementedError(
                "multi-token decode goes through the paged pool: pass "
                "block_table/block_size")
        new_pos = pos + S
        vmask = None
        if active_mask is not None:
            vmask = active_mask.reshape(-1, 1).expand(B, S)
        spec = self.moe_spec_decode
        if moe_policy is not None and moe_policy != spec.moe.policy:
            spec = dataclasses.replace(spec, moe=dataclasses.replace(
                spec.moe, policy=moe_policy,
                num_foreign_slots=_decode_foreign_slots(spec, moe_policy)))
        if S > 1:
            spec = dataclasses.replace(spec, tokens_local=spec.tokens_local * S)
        h = params["embed"][token]
        h, stack, diags = T.run_stack(
            h, params["stack"], self.cfg, cache=caches["stack"],
            cache_len=new_pos, q_offset=pos, moe_spec=spec, comm=self.comm,
            skew_key=skew_key, valid_mask=vmask, block_table=block_table,
            block_size=block_size, skew_assign=skew_assign,
            moe_replica_ids=moe_replica_ids,
            moe_residency_ids=moe_residency_ids,
            moe_layer_diags=moe_layer_diags,
            strict=bool(fused_attention) and block_table is not None)
        if S == 1:
            logits = self._head(params, h[:, -1])
        else:
            logits = self._head(params, h.reshape(B * S, -1)).reshape(B, S, -1)
        return logits, caches, new_pos, diags


def _decode_foreign_slots(spec: MoEBlockSpec, policy: str) -> int:
    """Foreign slots at decode: even_split lands every non-local expert,
    harmoeny keeps the configured K, the static policies need none."""
    topo = spec.topo
    if policy == "even_split":
        return topo.padded_experts - topo.experts_per_rank
    if policy == "harmoeny":
        return spec.moe.num_foreign_slots
    return 0


def build_model(cfg: ModelConfig, pcfg: ParallelConfig = ParallelConfig(), *,
                batch: int, seq_len: int, device=None,
                ep_degree: int = 1, comm=None) -> Model:
    """The port's model for a decoder-only dense/MoE ``cfg`` at expert-
    parallel degree ``ep_degree``: G ranks on the one device when G > 1
    (``VirtualGroup``), or, given ``comm`` (a ``DistComm`` of G
    processes), this process's rank.  ``device`` defaults to CUDA and
    raises when no GPU is present."""
    dev = resolve_device(device)
    if comm is not None and comm.size != ep_degree:
        raise ValueError(f"a communicator of {comm.size} ranks for EP "
                         f"degree {ep_degree}")
    unsupported = [
        (not cfg.is_moe or cfg.family != "moe", f"family {cfg.family!r}"),
        (cfg.is_encoder_decoder or cfg.num_prefix_embeddings > 0,
         "encoder-decoder / prefix-embedding models"),
        (cfg.rope_theta <= 0, "absolute position embeddings"),
        (cfg.global_attn_every > 0,
         "local and global attention layers"),
        (cfg.attn_logit_softcap > 0, "attention logit softcap"),
        (cfg.post_norm, "post-norm layers"),
        (cfg.name.startswith("gemma"), "gemma embedding scaling"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{cfg.name}: {what} not ported yet")
    if cfg.act not in ("swiglu", "gelu_mlp"):
        raise NotImplementedError(f"{cfg.name}: {cfg.act} MLPs not ported "
                                  f"yet")
    moe_spec = MoEBlockSpec(
        moe=cfg.moe, d_model=cfg.d_model, ep_degree=ep_degree,
        tokens_local=batch * seq_len,
        act="silu" if cfg.act == "swiglu" else "gelu",
        cf_pair=pcfg.moe_cf_pair, block_m=pcfg.moe_block_m)
    # decode: one token per sequence, 128-row tiles, K per policy
    moe_spec_decode = dataclasses.replace(
        moe_spec, tokens_local=batch, block_m=128,
        moe=dataclasses.replace(cfg.moe, num_foreign_slots=(
            _decode_foreign_slots(moe_spec, cfg.moe.policy))))
    if comm is None:
        comm = (LocalComm() if ep_degree == 1
                else VirtualGroup(ep_degree, dev))
    return Model(cfg=cfg, device=dev, moe_spec=moe_spec,
                 moe_spec_decode=moe_spec_decode, comm=comm)
