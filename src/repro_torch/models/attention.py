"""Attention: MHA/GQA with RoPE or absolute positions, a sliding window
(on every layer, or on the local layers of a local/global model), a logit
softcap, causal or full, through the hand-written kernels.

Port of ``repro/models/attention.py``: the projections and RoPE, the plain
``chunked_attention`` (the JAX package's prefill reference),
``full_attention_ref`` (its O(S^2) test oracle), ``decode_attention`` and
``paged_ring_decode_attention``, and the ``attention_block`` branches:

* ``continue_prefill``: x is a [B, C] prompt chunk at position
  ``q_offset`` (an int or a 0-d device tensor, which a captured step
  reads); its K/V are written into the slab scratch at
  [q_offset, q_offset + C) with ``index_copy_`` (the reference's
  ``dynamic_update_slice``).  Where the window cannot bind over the slab
  (no window, or window >= S_max) attention runs through the paged kernel
  over the slab viewed as B contiguous block chains (identity block table,
  ``largest_block_divisor(S_max)`` positions per block, ``cache_len =
  q_offset + C``), whose causal pruning stops at the write frontier; a
  binding window takes the plain ``chunked_attention``, as in JAX.
* paged decode / multi-query window (``block_table`` given): the S new
  positions of every row are written through its block-table row into the
  physical pool, and attention reads through the table.  A window that
  binds over the chain (0 < window <= chain length) wraps positions into a
  ring of M = round_up(window, block_size): position p at ring slot p % M,
  read by the plain ``paged_ring_decode_attention`` (``decode_ring``,
  single-query only).
* ``prefill_cache`` (S > 1 on a slab cache): a whole prompt attends over
  itself through the flash kernel (``chunked_attention`` under a window or
  a softcap, as in JAX), then its K/V fill the cache prefix [0, S); a
  window-clamped slab keeps the window's tail at its ring slots p % S_max.
* ``prefill`` (no cache: whisper's encoder, or ``kv_source``): attention
  over the inputs alone, full (non-causal) attention plain, as in JAX;
  ``cross_attention`` is the decoder's over the encoder's cached K/V.
* ``decode_slab`` (S = 1 on a slab cache): the new K/V land at
  ``cache_len - 1`` (a scalar or one position per row), or at
  ``(cache_len - 1) % S_max`` on a window-clamped slab (the slab ring),
  and ``decode_attention`` reads the slab; plain torch, as in the
  reference, which has no kernel there.

On CUDA tensors the kernel branches launch their kernel; on CPU tensors
its plain version.  With ``strict`` (the ``fused_attention`` switch of
``Model.prefill_chunk`` / ``decode_step``, which the serve engine's
``fused_paged_attention`` sets) a branch that has no kernel raises
``FusedPathUnavailable`` instead of running its plain form.  Caches are
updated in place (the JAX version returns new arrays): the returned cache
is the one passed in.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, round_up
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (largest_block_divisor,
                                                     paged_attention)
from repro_torch.models.layers import apply_rope

_NEG_INF = -1e30


class FusedPathUnavailable(NotImplementedError):
    """The kernels were required (strict) but no kernel serves the branch."""


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


def _record_dispatch(branch: str, *, fused: bool, has_kernel: bool = True,
                     strict: bool = False, reason: str = "",
                     kernels: bool = True) -> None:
    """Log a branch's dispatch.  ``has_kernel`` False: the branch has no
    kernel (``reason`` says why, in the JAX log's words), which ``strict``
    turns into ``FusedPathUnavailable``, as JAX's ``_record_dispatch``.
    ``kernels`` False: the caller asked for the plain branches (the
    hybrid stack's attention, as JAX's ``use_pallas=False``), and the
    record says it was not requested."""
    if has_kernel and not fused and kernels:
        reason = "the plain version runs on the CPU"
    rec = {"branch": branch, "fused": bool(fused), "reason": reason}
    if not kernels:
        rec["requested"] = False
    if len(_dispatch_log) < _DISPATCH_LOG_CAP:
        _dispatch_log.append(rec)
    if strict and not has_kernel:
        raise FusedPathUnavailable(
            f"attention_block: use_pallas was explicitly required but the "
            f"fused path cannot apply on branch {branch!r}: {reason}")


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return s if cap <= 0 else cap * torch.tanh(s / cap)


def _repeat_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: each kv head repeated for its ``rep`` q heads."""
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, softcap: float = 0.0,
                      chunk: int = 1024, q_offset=0) -> torch.Tensor:
    """Plain online-softmax attention over KV blocks of ``chunk``.
    q: [B, Sq, H, hd]; k/v: [B, Sk, Hkv, hd]; query i at q_offset + i (an
    int or a 0-d tensor); ``window`` > 0 keeps keys less than ``window``
    positions behind the query."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k, v = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
    qf = q.float() * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), _NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, hd), device=q.device)
    # under autograd each block is checkpointed, as JAX's scan step is:
    # backward recomputes its [Sq, chunk] scores instead of storing them
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for c0 in range(0, Sk, chunk):
        args = (m, l, acc, qf, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                q_pos, c0, causal, window, softcap)
        m, l, acc = (checkpoint(_attn_block, *args, use_reentrant=False)
                     if remat else _attn_block(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _attn_block(m, l, acc, qf, kb, vb, q_pos, c0: int, causal: bool,
                window: int, softcap: float):
    """One KV block of the online softmax: the running (max, denominator,
    accumulator) after it."""
    kb, vb = kb.float(), vb.float()
    kv_pos = c0 + torch.arange(kb.shape[1], device=qf.device)
    s = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kb), softcap)
    mask = _mask(q_pos, kv_pos, causal, window)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
    return m_new, l, acc


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """[Sq, Sk] keys each query sees (None: all of them)."""
    mask = None
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        w = q_pos[:, None] - kv_pos[None, :] < window
        mask = w if mask is None else mask & w
    return mask


def full_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, window: int = 0, softcap: float = 0.0,
                       q_offset: int = 0) -> torch.Tensor:
    """Naive O(S^2)-memory oracle for tests."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k, v = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
    qf = q.float() * hd ** -0.5
    s = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, k.float()), softcap)
    mask = _mask(q_offset + torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B, 1, H, hd] over slab caches [B, S_max, Hkv, hd]; cache_len a
    scalar or per-row [B] (entries < cache_len are valid, the new token's
    K/V already written at cache_len - 1; with ``window`` > 0 only the
    last ``window`` of them).  Masked f32 softmax."""
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1)  # [1 | B]
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    mask = kv_pos < cl[:, None]
    if window > 0:
        mask = mask & (kv_pos >= cl[:, None] - window)
    return _masked_decode(q, k_cache, v_cache, mask, softcap)


def _masked_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, softcap: float) -> torch.Tensor:
    """q [B, 1, H, hd] over k/v [B, L, Hkv, hd] where ``mask`` [B | 1, L]
    holds: masked f32 softmax."""
    H, hd = q.shape[2], q.shape[3]
    kr = _repeat_kv(k.float(), H // k.shape[2])
    vr = _repeat_kv(v.float(), H // k.shape[2])
    qf = (q.float() * hd ** -0.5)[:, 0]                         # [B, H, hd]
    s = _softcap(torch.einsum("bhd,bkhd->bhk", qf, kr), softcap)
    s = torch.where(mask[:, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vr)[:, None].to(q.dtype)


def paged_ring_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor, cache_len, *,
                                window: int, block_size: int,
                                softcap: float = 0.0) -> torch.Tensor:
    """Single-query decode through a paged pool whose logical positions
    wrap a ring of M = round_up(window, block_size) positions: absolute
    position p lives at ring slot p % M (block ``(p % M) // block_size``
    of the row's chain).  Ring slot r holds absolute position
    ``cache_len - 1 - ((cache_len - 1 - r) mod M)``, valid iff that age is
    below min(window, cache_len).  K is stored post-RoPE at its absolute
    position, so scores stay position-exact across wraps."""
    M = round_up(window, block_size)
    r = torch.arange(M, device=q.device)
    phys = (block_table[:, r // block_size].long() * block_size
            + r % block_size)                                   # [B, M]
    cl = torch.as_tensor(cache_len, device=q.device).to(
        torch.int32).reshape(-1).expand(q.shape[0])
    age = torch.remainder(cl[:, None].long() - 1 - r[None, :], M)
    valid = (age < window) & (age < cl[:, None])
    return _masked_decode(q, k_pool[0, phys], v_pool[0, phys], valid,
                          softcap)


def attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    cfg: ModelConfig, *, q_offset, cache: Optional[AttnCache],
                    cache_len=None, continue_prefill: bool = False,
                    block_table: Optional[torch.Tensor] = None,
                    block_size: int = 0, strict: bool = False,
                    kernels: bool = True, is_global: bool = True,
                    causal: bool = True,
                    kv_source: Optional[torch.Tensor] = None,
                    attn_chunk: int = 1024
                    ) -> Tuple[torch.Tensor, Optional[AttnCache]]:
    """Projections + RoPE + attention + out-projection.  ``q_offset`` is an
    int or a 0-d tensor (prefill, slab decode) or a per-row [B] tensor
    (paged or slab decode).  ``strict`` makes a branch without a kernel
    raise ``FusedPathUnavailable``.  ``kernels`` False runs the plain
    branches on every device (the slab ones only: ``chunked_attention``
    for a chunk or a whole prompt, ``decode_attention`` for a step), as
    JAX's ``attention_block`` with ``use_pallas=False``, and logs JAX's
    reasons.

    The layer's window is ``cfg.sliding_window``, or 0 on a global layer
    of a model with local and global layers (``is_global``, gemma2): every
    branch reads it.  ``causal`` False is full attention (whisper's
    encoder), which no kernel branch takes, as in JAX.  Without a cache
    (``cache`` None: the encoder) x attends over itself, or over
    ``kv_source`` [B, Sk, d] (cross-attention, keys without RoPE), and
    nothing is stored; its plain branch takes KV blocks of ``attn_chunk``
    (JAX's ``ParallelConfig.attn_chunk``; training's path).
    ``rope_theta <= 0`` (whisper's absolute positions) applies no RoPE."""
    B, S, _ = x.shape
    softcap = cfg.attn_logit_softcap
    window = 0 if (is_global and cfg.global_attn_every) else cfg.sliding_window
    kv_in = x if kv_source is None else kv_source
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"])
    ar = torch.arange(S, device=x.device)
    if cfg.rope_theta > 0 and kv_source is None:
        off = (q_offset.reshape(-1, 1)
               if torch.is_tensor(q_offset) and q_offset.ndim else q_offset)
        q = apply_rope(q, off + ar, cfg.rope_theta)
        k = apply_rope(k, off + ar, cfg.rope_theta)
    fused = x.device.type == "cuda"
    if not kernels and block_table is not None:
        raise NotImplementedError("the plain attention branches are the "
                                  "slab's: paged decode runs the kernel")

    if cache is None:
        # no cache (the encoder, cross-attention): the flash kernel's
        # guards are causal, no window and no softcap, as in JAX
        if kernels and causal and window == 0 and softcap == 0.0:
            _record_dispatch("prefill", fused=fused)
            out = flash_attention(q, k, v, causal=True)
        else:
            _record_dispatch(
                "prefill", fused=False, has_kernel=False, strict=strict,
                kernels=kernels,
                reason=(f"flash kernel guards failed (causal={causal}, "
                        f"window={window}, softcap={softcap})"))
            out = chunked_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset,
                                    chunk=attn_chunk)
    elif continue_prefill and block_table is None:
        # the chunk's start stays on the device (a host int would be baked
        # into a captured step): the writes go to start + [0, S)
        S_max = cache.k.shape[1]
        start = torch.as_tensor(q_offset, device=x.device).reshape(())
        at = start.long() + ar
        cache.k.index_copy_(1, at, k.to(cache.k.dtype))
        cache.v.index_copy_(1, at, v.to(cache.v.dtype))
        if kernels and causal and (window == 0 or window >= S_max):
            bs_slab = largest_block_divisor(S_max)
            nb = S_max // bs_slab
            Hkv, hd = cache.k.shape[2], cache.k.shape[3]
            table = (torch.arange(B, dtype=torch.int32,
                                  device=x.device)[:, None] * nb
                     + torch.arange(nb, dtype=torch.int32,
                                    device=x.device)[None, :])
            _record_dispatch("prefill_continue", fused=fused)
            out = paged_attention(q, cache.k.view(1, B * S_max, Hkv, hd),
                                  cache.v.view(1, B * S_max, Hkv, hd), table,
                                  (start + S).to(torch.int32),
                                  block_size=bs_slab, softcap=softcap)
        else:
            _record_dispatch(
                "prefill_continue", fused=False, has_kernel=False,
                strict=strict, kernels=kernels,
                reason=("non-causal attention" if not causal else
                        f"binding sliding window {window} < slab {S_max}"))
            out = chunked_attention(q, cache.k, cache.v, causal=causal,
                                    window=window, softcap=softcap,
                                    q_offset=start)
    elif block_table is not None:
        # a window binds over the chain: positions wrap a ring of M
        ring = 0 < window <= block_table.shape[1] * block_size
        if ring and S > 1:
            raise NotImplementedError(
                f"paged sliding-window ring decode (window={window}) is "
                f"single-query only; speculative verify windows are "
                f"rejected for windowed models at EngineConfig validation")
        cl = torch.as_tensor(cache_len, device=x.device).to(
            torch.int32).reshape(-1).expand(B)
        pos = cl[:, None].long() - S + ar[None]                # [B, S]
        if ring:
            pos = pos % round_up(window, block_size)
        rows = torch.arange(B, device=x.device)[:, None]
        widx = (block_table[rows, pos // block_size].long() * block_size
                + pos % block_size)                             # [B, S]
        cache.k[0, widx] = k.to(cache.k.dtype)
        cache.v[0, widx] = v.to(cache.v.dtype)
        if ring:
            _record_dispatch(
                "decode_ring", fused=False, has_kernel=False, strict=strict,
                reason=f"sliding-window ring decode (window={window}) has "
                       f"no fused kernel")
            out = paged_ring_decode_attention(
                q, cache.k, cache.v, block_table, cl, window=window,
                block_size=block_size, softcap=softcap)
        else:
            _record_dispatch("verify" if S > 1 else "decode", fused=fused)
            out = paged_attention(q, cache.k, cache.v, block_table, cl,
                                  block_size=block_size, softcap=softcap)
    elif S > 1:
        # whole prompt: the flash kernel's guards are causal, no window and
        # no softcap; otherwise the chunked reference
        if kernels and causal and window == 0 and softcap == 0.0:
            _record_dispatch("prefill_cache", fused=fused)
            out = flash_attention(q, k, v, causal=True)
        else:
            _record_dispatch(
                "prefill_cache", fused=False, has_kernel=False,
                strict=strict, kernels=kernels,
                reason=(f"flash kernel guards failed (causal={causal}, "
                        f"window={window}, softcap={softcap})"))
            out = chunked_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
        S_max = cache.k.shape[1]
        if S >= S_max and 0 < window and S_max <= window:
            # ring: keep the window tail, each position p at its ring slot
            # p % S_max, where slab ring decode writes next
            kw = torch.roll(k[:, S - S_max:], S % S_max, dims=1)
            vw = torch.roll(v[:, S - S_max:], S % S_max, dims=1)
        else:
            kw, vw = k[:, :S_max], v[:, :S_max]
        n = kw.shape[1]
        cache.k[:, :n] = kw.to(cache.k.dtype)
        cache.v[:, :n] = vw.to(cache.v.dtype)
    else:
        # a slab clamped to the window is a ring buffer: the write at
        # (cache_len - 1) % S_max overwrites the expired position
        S_max = cache.k.shape[1]
        ring = 0 < window and S_max <= window
        cl = torch.as_tensor(cache_len, device=x.device)
        scalar = cl.ndim == 0
        cl = cl.reshape(-1)
        rows = torch.arange(B, device=x.device)
        at = (cl.long() - 1).expand(B)
        if ring:
            at = at % S_max
        elif scalar:
            # one length for every row: JAX's dynamic_update_slice, which
            # clamps a write past the slab onto its last position
            at = at.clamp(max=S_max - 1)
        cache.k[rows, at] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, at] = v[:, 0].to(cache.v.dtype)
        _record_dispatch(
            "decode_slab", fused=False, has_kernel=False, strict=strict,
            kernels=kernels,
            reason="slab decode has no fused kernel (paged pool required)")
        out = decode_attention(q, cache.k, cache.v,
                               torch.clamp(cl, max=S_max) if ring else cl,
                               window=0 if ring else window, softcap=softcap)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def cross_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    kv: AttnCache, chunk: int = 1024) -> torch.Tensor:
    """Whisper's decoder cross-attention: x [B, S, d] attends over the
    encoder's precomputed K/V [B, S_enc, Hkv, hd] (``kv``), full and
    without RoPE, through the plain ``chunked_attention``, as JAX's
    ``_run_encdec_decoder`` computes it."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    out = chunked_attention(q, kv.k, kv.v, causal=False, chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
