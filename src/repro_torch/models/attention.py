"""Attention: MHA/GQA with RoPE through the hand-written kernels.

Port of ``repro/models/attention.py``: the projections and RoPE, the plain
``chunked_attention`` (the JAX package's prefill reference) and
``decode_attention``, and four ``attention_block`` branches:

* ``continue_prefill``: x is a [B, C] prompt chunk at position
  ``q_offset`` (an int or a 0-d device tensor, which a captured step
  reads); its K/V are written into the slab scratch at
  [q_offset, q_offset + C) with ``index_copy_`` (the reference's
  ``dynamic_update_slice``) and attention runs through the paged kernel
  over the slab viewed as B contiguous block chains (identity block table,
  ``largest_block_divisor(S_max)`` positions per block, ``cache_len =
  q_offset + C``), whose causal pruning stops at the write frontier.
* paged decode / multi-query window (``block_table`` given): the S new
  positions of every row are written through its block-table row into the
  physical pool, and attention reads through the table.
* ``prefill_cache`` (S > 1 on a slab cache): a whole prompt attends over
  itself through the flash kernel, then its K/V fill the cache prefix
  [0, S).
* ``decode_slab`` (S = 1 on a slab cache): the new K/V land at
  ``cache_len - 1`` (a scalar or one position per row) and
  ``decode_attention`` reads the slab; plain torch, as in the reference,
  which has no kernel there.

On CUDA tensors the kernel branches launch their kernel; on CPU tensors
its plain version.  Caches are updated in place (the JAX version returns
new arrays): the returned cache is the one passed in.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (largest_block_divisor,
                                                     paged_attention)
from repro_torch.models.layers import apply_rope

_NEG_INF = -1e30


class AttnCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, Hkv, hd] slab, or [1, P, Hkv, hd] pool
    v: torch.Tensor


# Dispatch record, one entry per attention_block call: which branch ran,
# whether it launched the CUDA kernel (``fused``) or, on the CPU, the
# kernel's plain version, and why the kernel did not run (``reason``).
# The serve engine snapshots it after warmup and reports it beside its
# config's ``fused_paged_attention`` (the JAX log's ``requested``).
_dispatch_log: list = []
_DISPATCH_LOG_CAP = 4096


def reset_dispatch_log() -> None:
    _dispatch_log.clear()


def dispatch_log() -> list:
    return list(_dispatch_log)


def _record_dispatch(branch: str, *, fused: bool, has_kernel: bool = True
                     ) -> None:
    if len(_dispatch_log) < _DISPATCH_LOG_CAP:
        reason = ("" if fused else
                  "the plain version runs on the CPU" if has_kernel else
                  "slab decode has no kernel (paged pool required)")
        _dispatch_log.append({"branch": branch, "fused": bool(fused),
                              "reason": reason})


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return s if cap <= 0 else cap * torch.tanh(s / cap)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, softcap: float = 0.0, chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Plain online-softmax attention over KV blocks of ``chunk``.
    q: [B, Sq, H, hd]; k/v: [B, Sk, Hkv, hd]; query i at q_offset + i."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q.float() * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), _NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, hd), device=q.device)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kb), softcap)
        if causal:
            s = torch.where(kv_pos[None, :] <= q_pos[:, None], s,
                            torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B, 1, H, hd] over slab caches [B, S_max, Hkv, hd]; cache_len a
    scalar or per-row [B] (entries < cache_len are valid, the new token's
    K/V already written at cache_len - 1).  Masked f32 softmax."""
    B, _, H, hd = q.shape
    S_max, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    kr, vr = k_cache.float(), v_cache.float()
    if rep > 1:
        kr = kr.repeat_interleave(rep, dim=2)
        vr = vr.repeat_interleave(rep, dim=2)
    qf = (q.float() * hd ** -0.5)[:, 0]                        # [B, H, hd]
    s = _softcap(torch.einsum("bhd,bkhd->bhk", qf, kr), softcap)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1)  # [1 | B]
    mask = torch.arange(S_max, device=q.device)[None, :] < cl[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, vr)
    return out[:, None].to(q.dtype)


def attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    cfg: ModelConfig, *, q_offset, cache: AttnCache,
                    cache_len=None, continue_prefill: bool = False,
                    block_table: Optional[torch.Tensor] = None,
                    block_size: int = 0) -> Tuple[torch.Tensor, AttnCache]:
    """Projections + RoPE + attention + out-projection.  ``q_offset`` is an
    int or a 0-d tensor (prefill, slab decode) or a per-row [B] tensor
    (paged or slab decode)."""
    B, S, _ = x.shape
    softcap = cfg.attn_logit_softcap
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    ar = torch.arange(S, device=x.device)
    off = (q_offset.reshape(-1, 1)
           if torch.is_tensor(q_offset) and q_offset.ndim else q_offset)
    q = apply_rope(q, off + ar, cfg.rope_theta)
    k = apply_rope(k, off + ar, cfg.rope_theta)
    fused = x.device.type == "cuda"

    if continue_prefill and block_table is None:
        # the chunk's start stays on the device (a host int would be baked
        # into a captured step): the writes go to start + [0, S)
        S_max = cache.k.shape[1]
        start = torch.as_tensor(q_offset, device=x.device).reshape(())
        at = start.long() + ar
        cache.k.index_copy_(1, at, k.to(cache.k.dtype))
        cache.v.index_copy_(1, at, v.to(cache.v.dtype))
        bs_slab = largest_block_divisor(S_max)
        nb = S_max // bs_slab
        Hkv, hd = cache.k.shape[2], cache.k.shape[3]
        table = (torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
                 * nb + torch.arange(nb, dtype=torch.int32,
                                     device=x.device)[None, :])
        _record_dispatch("prefill_continue", fused=fused)
        out = paged_attention(q, cache.k.view(1, B * S_max, Hkv, hd),
                              cache.v.view(1, B * S_max, Hkv, hd), table,
                              (start + S).to(torch.int32),
                              block_size=bs_slab, softcap=softcap)
    elif block_table is not None:
        cl = torch.as_tensor(cache_len, device=x.device).to(
            torch.int32).reshape(-1).expand(B)
        pos = cl[:, None].long() - S + ar[None]                # [B, S]
        rows = torch.arange(B, device=x.device)[:, None]
        widx = (block_table[rows, pos // block_size].long() * block_size
                + pos % block_size)                             # [B, S]
        cache.k[0, widx] = k.to(cache.k.dtype)
        cache.v[0, widx] = v.to(cache.v.dtype)
        _record_dispatch("verify" if S > 1 else "decode", fused=fused)
        out = paged_attention(q, cache.k, cache.v, block_table, cl,
                              block_size=block_size, softcap=softcap)
    elif S > 1:
        # whole prompt: the flash kernel's guards (causal, no window, no
        # softcap) hold for every model build_model accepts
        if softcap:
            raise NotImplementedError("prefill_cache with a logit softcap "
                                      "is not ported")
        _record_dispatch("prefill_cache", fused=fused)
        out = flash_attention(q, k, v, causal=True)
        n = min(S, cache.k.shape[1])
        cache.k[:, :n] = k[:, :n].to(cache.k.dtype)
        cache.v[:, :n] = v[:, :n].to(cache.v.dtype)
    else:
        cl = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        rows = torch.arange(B, device=x.device)
        at = (cl.long() - 1).expand(B)
        cache.k[rows, at] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, at] = v[:, 0].to(cache.v.dtype)
        _record_dispatch("decode_slab", fused=False, has_kernel=False)
        out = decode_attention(q, cache.k, cache.v, cl, softcap=softcap)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
