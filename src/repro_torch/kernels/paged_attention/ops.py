"""Paged attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/paged_attention/`` (``paged_attention_kernel``,
``ops.paged_attention``, ``ops.largest_block_divisor``,
``ref.paged_attention_ref``).  One kernel serves paged decode (S = 1),
multi-query windows and prefill chunks over the slab-as-pool view.
``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs ``paged_attention_plain`` for CPU tensors; there is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def largest_block_divisor(n: int, cap: int = 128) -> int:
    """Largest divisor of ``n`` that is <= cap (>= 1 always exists): the
    block size that views a [B, S_max] slab as contiguous block chains."""
    for bs in range(min(cap, n), 0, -1):
        if n % bs == 0:
            return bs
    return 1


def _lengths(cache_len, B: int, device) -> torch.Tensor:
    cl = torch.as_tensor(cache_len, device=device).reshape(-1)
    return cl.to(torch.int32).expand(B).contiguous()


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          cache_len, *, block_size: int,
                          softcap: float = 0.0) -> torch.Tensor:
    """Gather each row's logical K/V through its table row, repeat KV heads,
    masked f32 softmax over the whole logical range (the reference the
    kernel must match).  Query i of row b sits at ``cache_len[b] - S + i``
    and sees ``kv_pos <= q_pos`` and ``kv_pos < cache_len[b]``."""
    B, S, H, hd = q.shape
    Hkv = k_pool.shape[2]
    rep = H // Hkv
    n_blocks = block_table.shape[1]
    log = torch.arange(n_blocks * block_size, device=q.device)
    phys = (block_table.long()[:, log // block_size] * block_size
            + log % block_size)                              # [B, L_max]
    k = k_pool[0][phys].float()                              # [B, L, Hkv, hd]
    v = v_pool[0][phys].float()
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q.float() * hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    cl = _lengths(cache_len, B, q.device).long()
    q_pos = cl[:, None] - S + torch.arange(S, device=q.device)[None]
    mask = ((log[None, None, :] <= q_pos[:, :, None])
            & (log[None, None, :] < cl[:, None, None]))     # [B, S, L]
    s = torch.where(mask[:, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _lib():
    fn = build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    cache_len, *, block_size: int,
                    softcap: float = 0.0) -> torch.Tensor:
    """Model-layout entry: q [B, S, H, hd]; k_pool/v_pool [1, P, Hkv, hd]
    physical pools with P = num_blocks * block_size; block_table
    [B, n_blocks] int32; cache_len scalar or [B], the valid length
    INCLUDING the S window positions -> [B, S, H, hd].

    The kernel reads q in place: query i, head h = g * rep + r of kv head g
    is row ``i * rep + r`` of (b, g)'s tile, the TPU wrapper's layout."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     cache_len, block_size=block_size,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    P, Hkv = k_pool.shape[1], k_pool.shape[2]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention takes float32 or bfloat16 q and "
                        "pools of q's dtype")
    if hd % 32 or hd > 128 or H % Hkv or P % block_size \
            or k_pool.shape != (1, P, Hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention kernel needs hd % 32 == 0, "
                         f"hd <= 128, H % Hkv == 0 and whole blocks; got "
                         f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"block_size {block_size}")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B:
        raise ValueError("paged_attention: block_table must be int32 [B, n]")
    for t in (q, k_pool, v_pool, block_table):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous "
                             "tensors on q's device")
    cl = _lengths(cache_len, B, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_table.data_ptr(), cl.data_ptr(),
                out.data_ptr(), B, S, H, Hkv, hd, block_size,
                block_table.shape[1], float(softcap), float(hd ** -0.5),
                stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0     # kernel launches (CUDA tensors only)
