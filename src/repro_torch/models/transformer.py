"""Decoder stack for the MoE family (port of
``repro/models/transformer.py``: ``layer_pattern``, ``run_stack``,
``init_stack_cache``).

Parameters stay stacked per layer exactly as in the JAX package
(``params["blocks"]["sub{j}"]`` leaves carry a leading ``n_steps`` axis),
so converting JAX weights is a reshape-free copy; a Python loop over the
steps replaces ``lax.scan``.  A period of the stack is one MoE layer or,
with ``moe_layer_period`` p > 1, p layers of which the one at
``moe_layer_offset`` is MoE and the others dense (switch128: ``["dense",
"moe"]``).  Leading dense layers (moonshot's first layer) are unstacked,
one dict per layer in ``params["lead"]`` and one ``AttnCache`` per layer
in ``cache["lead"]``, and run before the stack.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.core.router import SkewKey
from repro_torch.models import attention as A
from repro_torch.models.layers import mlp, norm


def layer_pattern(cfg: ModelConfig) -> Tuple[List[str], int, int]:
    """(pattern, n_steps, n_lead_dense): layer kinds within one period of
    the stack, the number of periods, and leading unscanned dense layers
    (the MoE family's patterns of the JAX ``layer_pattern``)."""
    lead = cfg.moe.first_dense_layers if cfg.is_moe else 0
    L = cfg.num_layers - lead
    p = cfg.moe.moe_layer_period if cfg.is_moe else 1
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
    if isinstance(tree, A.AttnCache):
        return A.AttnCache(tree.k[i], tree.v[i])
    return tree[i]


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device, clamp_window: bool = True) -> Dict[str, Any]:
    """Stacked K/V caches [n_steps, batch, s_max, Hkv, hd] per pattern slot,
    plus a list of [batch, s_max, Hkv, hd] caches for the lead layers.  A
    sliding-window model's caches hold min(s_max, window) positions, a ring
    buffer; ``clamp_window=False`` keeps every leaf at ``s_max`` (the
    serve engine's paged mode, where the window is enforced by ring-index
    arithmetic and masks, not by storage)."""
    pattern, n_steps, lead = layer_pattern(cfg)
    if clamp_window and cfg.sliding_window and not cfg.global_attn_every:
        s_max = min(s_max, cfg.sliding_window)
    shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)

    def one(lead_shape=()):
        full = lead_shape + shape
        return A.AttnCache(torch.zeros(full, dtype=dtype, device=device),
                           torch.zeros(full, dtype=dtype, device=device))
    cache: Dict[str, Any] = {"blocks": {f"sub{j}": one((n_steps,))
                                        for j in range(len(pattern))}}
    if lead:
        cache["lead"] = [one() for _ in range(lead)]
    return cache


def _apply_one_layer(x, p, kind: str, cfg: ModelConfig, *, cache, q_offset,
                     cache_len, moe_spec: MoEBlockSpec, comm, skew_key,
                     continue_prefill: bool, valid_mask, block_table,
                     block_size: int, strict: bool,
                     skew_assign=None, moe_replica_ids=None,
                     moe_residency_ids=None):
    """norm -> attention -> residual -> norm -> MoE block (+ shared
    experts) or, for a ``"dense"`` layer, the MLP of ``cfg.act`` ->
    residual.  Returns (x, diagnostics of this layer; none for a dense
    layer)."""
    h, _ = A.attention_block(
        norm(x, p["norm1"], cfg.norm), p["attn"], cfg, q_offset=q_offset,
        cache=cache, cache_len=cache_len, continue_prefill=continue_prefill,
        block_table=block_table, block_size=block_size, strict=strict)
    x = x + h
    h = norm(x, p["norm2"], cfg.norm)
    if kind == "dense":
        return x + mlp(h, p["mlp"], cfg.act), {}
    # the shared experts run while the block's foreign fetch is in flight
    # (paper §4.3); the block adds them last, moe_y + shared
    shared = ((lambda: mlp(h, p["shared_mlp"], cfg.act))
              if "shared_mlp" in p else None)
    y, mdiag = moe_block(h, p["moe"], spec=moe_spec, comm=comm,
                         skew_key=skew_key, valid_mask=valid_mask,
                         skew_assign=skew_assign,
                         replica_ids=moe_replica_ids,
                         residency_ids=moe_residency_ids, shared=shared)
    # collapse the leading batch-group axis only
    return x + y, {k: v.mean(dim=0) for k, v in mdiag.items()}


def run_stack(x: torch.Tensor, params: Dict[str, Any], cfg: ModelConfig, *,
              cache: Dict[str, Any], cache_len=None, q_offset=0,
              moe_spec: MoEBlockSpec, comm=None,
              skew_key: Optional[SkewKey] = None,
              continue_prefill: bool = False, valid_mask=None,
              block_table=None, block_size: int = 0,
              skew_assign: Optional[torch.Tensor] = None,
              moe_replica_ids: Optional[torch.Tensor] = None,
              moe_residency_ids: Optional[torch.Tensor] = None,
              moe_layer_diags: bool = False, strict: bool = False
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
    which the tiered-residency manager reads.  ``strict`` goes to every
    ``attention_block``."""
    pattern, n_steps, lead = layer_pattern(cfg)
    kw = dict(q_offset=q_offset, cache_len=cache_len, moe_spec=moe_spec,
              comm=comm, continue_prefill=continue_prefill,
              valid_mask=valid_mask, block_table=block_table,
              block_size=block_size, strict=strict)
    moe_kw = dict(moe_replica_ids=moe_replica_ids,
                  moe_residency_ids=moe_residency_ids)
    for i in range(lead):
        x, _ = _apply_one_layer(x, params["lead"][i], "dense", cfg,
                                cache=cache["lead"][i], skew_key=None, **kw)
    per_step: Dict[str, List[torch.Tensor]] = {}
    n_moe = 0
    for i in range(n_steps):
        p_step = layer_slice(params["blocks"], i)
        for j in range(len(pattern)):
            layer_key = (None if skew_key is None
                         else skew_key.fold_in(i * len(pattern) + j))
            drawn = None
            if skew_assign is not None and pattern[j] == "moe":
                drawn = skew_assign[n_moe]
                n_moe += 1
            x, d = _apply_one_layer(
                x, p_step[f"sub{j}"], pattern[j], cfg,
                cache=layer_slice(cache["blocks"][f"sub{j}"], i),
                skew_key=layer_key, skew_assign=drawn, **kw, **moe_kw)
            for k, v in d.items():
                per_step.setdefault(k, []).append(v)
    diags = {k: torch.stack(v).mean(dim=0) for k, v in per_step.items()}
    if moe_layer_diags and "expert_load" in per_step:
        diags["expert_load_layers"] = torch.stack(per_step["expert_load"])
    return x, cache, diags
