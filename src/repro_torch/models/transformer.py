"""Decoder stacks: the MoE family's, the dense decoders' (gemma2's local
and global layers among them), mamba2's, and the zamba2 hybrid (port of
``repro/models/transformer.py``: ``layer_pattern``, ``run_stack``,
``init_stack_cache``, ``init_hybrid_cache``, ``run_hybrid``).

Parameters stay stacked per layer exactly as in the JAX package
(``params["blocks"]["sub{j}"]`` leaves carry a leading ``n_steps`` axis),
so converting JAX weights is a reshape-free copy; a Python loop over the
steps replaces ``lax.scan``.  A period of the stack is one MoE layer or,
with ``moe_layer_period`` p > 1, p layers of which the one at
``moe_layer_offset`` is MoE and the others dense (switch128: ``["dense",
"moe"]``); a dense decoder's period is one dense layer, or gemma2's
``["attn_local", "attn_global"]``, whose local layers' slab caches are
clamped to the window.  Leading dense layers (moonshot's first layer) are
unstacked, one dict per layer in
``params["lead"]`` and one ``AttnCache`` per layer in ``cache["lead"]``,
and run before the stack.  The SSM family's stack is one ``"mamba"``
layer a period, whose cache is a ``MambaState`` of fixed-size recurrent
state (no KV-length axis).

The hybrid (zamba2) runs ``attn_every`` mamba layers a group
(``params["groups"]`` leaves ``[n_groups, attn_every, ...]``), then one
attention(+MLP) block whose weights every group shares
(``params["shared"]``) over a K/V cache of its own a group
(``cache["attn"]`` ``[n_groups, B, S, Hkv, hd]``), and the remainder
layers as a tail (``params["tail"]``, a list: zamba2's 81 = 13 x 6 + 3).
Its attention runs the plain slab branches on every device, as JAX's
``run_hybrid`` calls ``attention_block`` without ``use_pallas``.

Training runs both stacks without a cache (``cache`` None: JAX's
``mode="train"``), on the plain branches (``kernels`` False), and with
``remat`` each period of ``run_stack`` (each group of ``run_hybrid``)
under ``torch.utils.checkpoint``, as JAX wraps its scan body in
``jax.checkpoint``: only the period's input is kept, and its activations
are recomputed in backward.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.core.router import SkewKey
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import mlp, norm


def layer_pattern(cfg: ModelConfig) -> Tuple[List[str], int, int]:
    """(pattern, n_steps, n_lead_dense): layer kinds within one period of
    the stack, the number of periods, and leading unscanned dense layers
    (the JAX ``layer_pattern``'s MoE, SSM, dense-decoder and local/global
    patterns).  ``"attn_local"`` and ``"attn_global"`` are dense layers
    whose attention takes the sliding window or not."""
    if cfg.family == "ssm":
        return ["mamba"], cfg.num_layers, 0
    if not cfg.is_moe:
        p = cfg.global_attn_every
        if p > 1:                 # gemma2: p - 1 local layers, then a global
            if cfg.num_layers % p:
                raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are "
                                 f"not a whole number of periods of {p}")
            return (["attn_local"] * (p - 1) + ["attn_global"],
                    cfg.num_layers // p, 0)
        return ["dense"], cfg.num_layers, 0
    lead = cfg.moe.first_dense_layers
    L = cfg.num_layers - lead
    p = cfg.moe.moe_layer_period
    if p > 1:
        if L % p:
            raise ValueError(f"{cfg.name}: {L} layers are not a whole number "
                             f"of periods of {p}")
        pat = ["dense"] * p
        pat[cfg.moe.moe_layer_offset] = "moe"
        return pat, L // p, lead
    return ["moe"], L, lead


def moe_layer_keys(cfg: ModelConfig) -> List[int]:
    """The index ``run_stack`` folds into the skew key for each MoE layer,
    in order: ``i * len(pattern) + j`` for sub-layer j of period i."""
    pattern, n_steps, _ = layer_pattern(cfg)
    return [i * len(pattern) + j for i in range(n_steps)
            for j, kind in enumerate(pattern) if kind == "moe"]


def layer_slice(tree: Any, i: int) -> Any:
    """Step ``i`` of a stacked parameter / cache tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):                 # AttnCache, MambaState
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device, clamp_window: bool = True) -> Dict[str, Any]:
    """Stacked K/V caches [n_steps, batch, s_max, Hkv, hd] per pattern slot,
    plus a list of [batch, s_max, Hkv, hd] caches for the lead layers.  A
    sliding-window model's caches (a local/global model's local layers'
    only) hold min(s_max, window) positions, a ring buffer;
    ``clamp_window=False`` keeps every leaf at ``s_max`` (the serve
    engine's paged mode, where the window is enforced by ring-index
    arithmetic and masks, not by storage)."""
    pattern, n_steps, lead = layer_pattern(cfg)
    if pattern == ["mamba"]:
        return {"blocks": {"sub0": M.init_state(batch, cfg, dtype, device,
                                                lead=(n_steps,))}}

    def one(kind, lead_shape=()):
        s = s_max
        window = cfg.sliding_window
        if clamp_window and (kind == "attn_local"
                             or (window and not cfg.global_attn_every)):
            s = min(s_max, window)    # a ring buffer for windowed layers
        full = lead_shape + (batch, s, cfg.num_kv_heads,
                             cfg.resolved_head_dim)
        return A.AttnCache(torch.zeros(full, dtype=dtype, device=device),
                           torch.zeros(full, dtype=dtype, device=device))
    cache: Dict[str, Any] = {"blocks": {f"sub{j}": one(kind, (n_steps,))
                                        for j, kind in enumerate(pattern)}}
    if lead:
        cache["lead"] = [one("dense") for _ in range(lead)]
    return cache


def _apply_one_layer(x, p, kind: str, cfg: ModelConfig, *, cache, q_offset,
                     cache_len, moe_spec: MoEBlockSpec, comm, skew_key,
                     continue_prefill: bool, valid_mask, block_table,
                     block_size: int, strict: bool,
                     skew_assign=None, moe_replica_ids=None,
                     moe_residency_ids=None, causal: bool = True,
                     kernels: bool = True, attn_chunk: int = 1024):
    """norm -> attention -> residual -> norm -> MoE block (+ shared
    experts) or, for a ``"dense"``, ``"attn_local"`` or ``"attn_global"``
    layer, the MLP of ``cfg.act`` -> residual, with gemma2's post-norms
    on each sub-layer's output before its residual (``cfg.post_norm``);
    for a ``"mamba"`` layer norm -> mamba block -> residual, the layer's
    state updated in place (none without a cache: training).
    ``attn_chunk`` is the KV block of the plain attention without a
    cache.  Returns (x, diagnostics of this layer; none for a dense or
    mamba layer)."""
    if kind == "mamba":
        return _mamba_layer(x, p, cfg, cache, _valid_len(valid_mask)), {}
    h, _ = A.attention_block(
        norm(x, p["norm1"], cfg.norm), p["attn"], cfg, q_offset=q_offset,
        cache=cache, cache_len=cache_len, continue_prefill=continue_prefill,
        block_table=block_table, block_size=block_size, strict=strict,
        is_global=kind != "attn_local", causal=causal, kernels=kernels,
        attn_chunk=attn_chunk)
    if cfg.post_norm:
        h = norm(h, p["post_norm1"], cfg.norm)
    x = x + h
    h = norm(x, p["norm2"], cfg.norm)
    if kind != "moe":
        h = mlp(h, p["mlp"], cfg.act)
        if cfg.post_norm:
            h = norm(h, p["post_norm2"], cfg.norm)
        return x + h, {}
    # the shared experts run while the block's foreign fetch is in flight
    # (paper §4.3); the block adds them last, moe_y + shared
    shared = ((lambda: mlp(h, p["shared_mlp"], cfg.act))
              if "shared_mlp" in p else None)
    y, mdiag = moe_block(h, p["moe"], spec=moe_spec, comm=comm,
                         skew_key=skew_key, valid_mask=valid_mask,
                         skew_assign=skew_assign,
                         replica_ids=moe_replica_ids,
                         residency_ids=moe_residency_ids, shared=shared,
                         kernels=kernels)
    if cfg.post_norm:
        y = norm(y, p["post_norm2"], cfg.norm)
    # collapse the leading batch-group axis only
    return x + y, {k: v.mean(dim=0) for k, v in mdiag.items()}


def _valid_len(valid_mask):
    """A chunk's real tokens a row ([B]) from its prefix mask [B, S]."""
    return None if valid_mask is None else valid_mask.sum(dim=1)


def _mamba_layer(x, p, cfg: ModelConfig, state, valid_len):
    """norm -> mamba block -> residual; ``state`` (a ``MambaState`` of
    views into the cache, or None in training) takes the new state in
    place."""
    h, new = M.mamba_block(norm(x, p["norm1"], cfg.norm), p["mamba"], cfg,
                           state=state, valid_len=valid_len)
    if state is not None:
        for dst, src in zip(state, new):
            dst.copy_(src)
    return x + h


def run_stack(x: torch.Tensor, params: Dict[str, Any], cfg: ModelConfig, *,
              cache: Optional[Dict[str, Any]], cache_len=None, q_offset=0,
              moe_spec: Optional[MoEBlockSpec], comm=None,
              skew_key: Optional[SkewKey] = None,
              continue_prefill: bool = False, valid_mask=None,
              block_table=None, block_size: int = 0,
              skew_assign: Optional[torch.Tensor] = None,
              moe_replica_ids: Optional[torch.Tensor] = None,
              moe_residency_ids: Optional[torch.Tensor] = None,
              moe_layer_diags: bool = False, strict: bool = False,
              causal: bool = True, kernels: bool = True,
              remat: bool = False, attn_chunk: int = 1024
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Run every layer on x [B, S, d], updating ``cache`` in place, the MoE
    blocks over ``comm``'s EP group.  ``skew_key`` (synthetic router
    skew) is folded with each layer's index (``moe_layer_keys``);
    ``skew_assign`` [n_moe_layers, n, t_slice, k] holds assignments drawn
    beforehand on those keys, one slice per MoE layer in order, one row
    per rank this process runs (``moe_block``).
    ``moe_replica_ids`` [G, R] and ``moe_residency_ids`` [G, W] are the
    serving-time placement tables every MoE block reads
    (``moe_layer.moe_block``).  Returns (x, cache, diags averaged over the
    MoE layers); ``moe_layer_diags`` adds ``expert_load_layers``
    [n_moe_layers, Ep], each MoE layer's expert loads before the mean,
    which the tiered-residency manager reads.  ``strict``, ``causal`` and
    ``kernels`` go to every ``attention_block``, ``kernels`` to every MoE
    block too; without a cache (``cache`` None: whisper's encoder, and
    training) nothing is stored.  ``remat`` runs each period under
    ``torch.utils.checkpoint``; ``attn_chunk`` is the plain attention's
    KV block without a cache."""
    pattern, n_steps, lead = layer_pattern(cfg)
    kw = dict(q_offset=q_offset, cache_len=cache_len, moe_spec=moe_spec,
              comm=comm, continue_prefill=continue_prefill,
              valid_mask=valid_mask, block_table=block_table,
              block_size=block_size, strict=strict, causal=causal,
              kernels=kernels, attn_chunk=attn_chunk)
    moe_kw = dict(moe_replica_ids=moe_replica_ids,
                  moe_residency_ids=moe_residency_ids)
    for i in range(lead):
        x, _ = _apply_one_layer(x, params["lead"][i], "dense", cfg,
                                cache=None if cache is None
                                else cache["lead"][i], skew_key=None, **kw)
    per_step: Dict[str, List[torch.Tensor]] = {}
    moe_before = [sum(1 for kind in pattern[:j] if kind == "moe")
                  for j in range(len(pattern))]
    n_moe_step = sum(1 for kind in pattern if kind == "moe")

    def period(x, i):
        """Period i's layers on x -> (x, each layer's diagnostics)."""
        p_step = layer_slice(params["blocks"], i)
        ds = []
        for j in range(len(pattern)):
            layer_key = (None if skew_key is None
                         else skew_key.fold_in(i * len(pattern) + j))
            drawn = None
            if skew_assign is not None and pattern[j] == "moe":
                drawn = skew_assign[i * n_moe_step + moe_before[j]]
            x, d = _apply_one_layer(
                x, p_step[f"sub{j}"], pattern[j], cfg,
                cache=(None if cache is None else
                       layer_slice(cache["blocks"][f"sub{j}"], i)),
                skew_key=layer_key, skew_assign=drawn, **kw, **moe_kw)
            ds.append(d)
        return x, ds

    for i in range(n_steps):
        if remat:
            x, ds = checkpoint(period, x, i, use_reentrant=False)
        else:
            x, ds = period(x, i)
        for d in ds:
            for k, v in d.items():
                per_step.setdefault(k, []).append(v)
    diags = {k: torch.stack(v).mean(dim=0) for k, v in per_step.items()}
    if moe_layer_diags and "expert_load" in per_step:
        diags["expert_load_layers"] = torch.stack(per_step["expert_load"])
    return x, cache, diags


# ----------------------------------------------------------------------
# zamba2 hybrid: mamba groups + one shared attention(+MLP) block
# ----------------------------------------------------------------------
def hybrid_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(layers a group, groups, tail layers)."""
    per = cfg.attn_every
    n_groups = cfg.num_layers // per
    return per, n_groups, cfg.num_layers - n_groups * per


def init_hybrid_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                      device) -> Dict[str, Any]:
    """Each mamba layer's state ``[n_groups, per, batch, ...]``, one K/V
    cache ``[n_groups, batch, s_max, Hkv, hd]`` for each application of
    the shared attention block, and the tail's states, a list."""
    per, n_groups, rem = hybrid_shape(cfg)
    shape = (n_groups, batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache: Dict[str, Any] = {
        "mamba": M.init_state(batch, cfg, dtype, device,
                              lead=(n_groups, per)),
        "attn": A.AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))}
    if rem:
        cache["tail"] = [M.init_state(batch, cfg, dtype, device)
                         for _ in range(rem)]
    return cache


def run_hybrid(x: torch.Tensor, params: Dict[str, Any], cfg: ModelConfig, *,
               cache: Optional[Dict[str, Any]], cache_len=None, q_offset=0,
               continue_prefill: bool = False, valid_mask=None,
               remat: bool = False, attn_chunk: int = 1024
               ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """Run the hybrid stack on x [B, S, d], updating ``cache`` in place:
    every group's mamba layers, then the shared attention(+MLP) block on
    the group's own K/V cache (plain slab branches), then the tail.  Pad
    positions past ``valid_mask``'s prefix stay out of the recurrent
    state.  Without a cache (training) nothing is stored, the attention
    takes ``attn_chunk`` KV blocks, and ``remat`` runs each group under
    ``torch.utils.checkpoint``.  Returns (x, cache, {})."""
    per, n_groups, rem = hybrid_shape(cfg)
    shared = params["shared"]
    vlen = _valid_len(valid_mask)

    def group(x, g):
        p_grp = layer_slice(params["groups"], g)
        c_grp = None if cache is None else layer_slice(cache["mamba"], g)
        for i in range(per):
            x = _mamba_layer(x, layer_slice(p_grp, i), cfg,
                             None if c_grp is None
                             else layer_slice(c_grp, i), vlen)
        h, _ = A.attention_block(
            norm(x, shared["norm1"], cfg.norm), shared["attn"], cfg,
            q_offset=q_offset,
            cache=None if cache is None else layer_slice(cache["attn"], g),
            cache_len=cache_len, continue_prefill=continue_prefill,
            kernels=False, attn_chunk=attn_chunk)
        x = x + h
        return x + mlp(norm(x, shared["norm2"], cfg.norm), shared["mlp"],
                       cfg.act)

    for g in range(n_groups):
        x = (checkpoint(group, x, g, use_reentrant=False) if remat
             else group(x, g))
    for i in range(rem):
        x = _mamba_layer(x, params["tail"][i], cfg,
                         None if cache is None else cache["tail"][i], vlen)
    return x, cache, {}
