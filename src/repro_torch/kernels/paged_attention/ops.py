"""Paged attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/paged_attention/`` (``paged_attention_kernel``,
``ops.paged_attention``, ``ops.largest_block_divisor``,
``ref.paged_attention_ref``).  One kernel serves paged decode (S = 1),
multi-query windows and prefill chunks over the slab-as-pool view.
``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs ``paged_attention_plain`` for CPU tensors; there is no fallback
from one to the other.  ``launch_plan`` picks the kernel's route and cuts
each chain into position spans from shapes alone (split-KV), so the
wrapper never reads ``cache_len`` on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
H100_SMS = 132
TC_ROWS = 16          # q rows of a tensor-core tile (mma.sync m16n8k16)
TC_STAGE = 64         # positions of a tensor-core stage
MAX_SPLITS = 256      # spans a chain at most (the merge's shared memory)
WAVES = 4             # the planner's target: WAVES x SMs blocks


class LaunchPlan(NamedTuple):
    tensor_cores: bool   # bf16 tiles of 16 rows on mma.sync, else CUDA cores
    qt: int              # q rows of a tile
    n_tiles: int         # q tiles of each (row, kv head)
    n_splits: int        # position spans of each chain
    span: int            # positions of a span
    ctas: int            # blocks of the grid: n_tiles * n_splits * Hkv * B


def split_plan(capacity: int, groups: int, min_span: int,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_splits, span) cutting each of ``groups`` chains of ``capacity``
    positions into spans of ``span`` positions: enough spans for WAVES
    waves of ``sms`` blocks, but no more than the chain has ``min_span``
    stretches (ceil(capacity / min_span)) and at most MAX_SPLITS.  Four
    waves: at most three 64 KB blocks fit an SM, and on long chains four
    waves ran faster than two or six on an H100
    (``scripts/paged_attention_splits.py``).  Span s holds positions
    [s * span, min((s + 1) * span, capacity)); spans start and end
    wherever the arithmetic puts them, mid-block included.  Shapes only:
    the rows' lengths are never read."""
    want = max(1, -(-WAVES * sms // max(groups, 1)))
    n = max(1, min(want, -(-capacity // min_span), MAX_SPLITS))
    span = -(-capacity // n)
    return -(-capacity // span), span


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, S: int, H: int, Hkv: int, hd: int,
                dtype: torch.dtype, n_blocks: int, block_size: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's route and grid for these shapes.  bf16 tiles of at
    least 16 rows (S * rep) take the tensor cores; decode and every f32
    tile the CUDA cores, with tiles of 1, 2, 4 or 8 rows.  A CUDA-core
    stage holds 16 KB of K and V (16 * 32 / (hd * size / 16) positions)
    and a span at least two of them, so that its ring overlaps a copy with
    a stage's math (spans of one stage ran slower on serve decode: more
    blocks, nothing overlapped); a tensor-core stage is 64 positions and a
    span at least one."""
    rows = S * (H // Hkv)
    tc = dtype == torch.bfloat16 and rows >= TC_ROWS
    if tc:
        qt, min_span = TC_ROWS, TC_STAGE
    else:
        qt = min(8, 1 << (rows - 1).bit_length())
        min_span = 2 * 16 * (32 // (hd * (torch.finfo(dtype).bits // 8)
                                    // 16))
    n_tiles = -(-rows // qt)
    n_splits, span = split_plan(n_blocks * block_size, B * Hkv * n_tiles,
                                min_span, sms)
    return LaunchPlan(tc, qt, n_tiles, n_splits, span,
                      n_tiles * n_splits * Hkv * B)


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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The merge's counters, one buffer per device, kept across calls: the
# kernel leaves them at zero, so a call needs no memset launch of its own.
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The merge's per-group counters: zero between calls (the last block
    of each group resets its own), grown when a call needs more.  Calls
    share them, so launches on one device run on one stream.  A captured
    step's calls use the buffer its eager warm step sized: it is never
    made inside a capture."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_attention: the merge counters are "
                               "sized by an eager call, not inside a capture")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    cache_len, *, block_size: int,
                    softcap: float = 0.0) -> torch.Tensor:
    """Model-layout entry: q [B, S, H, hd]; k_pool/v_pool [1, P, Hkv, hd]
    physical pools with P = num_blocks * block_size; block_table
    [B, n_blocks] int32; cache_len scalar or [B], the valid length
    INCLUDING the S window positions -> [B, S, H, hd].

    The kernel reads q in place: query i, head h = g * rep + r of kv head g
    is row ``i * rep + r`` of (b, g)'s tile, the TPU wrapper's layout.  A
    chain cut into several spans takes a workspace for the spans' partials
    (``torch.empty``) and the shared merge counters; one call is one
    device launch either way."""
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
    if hd not in HEAD_DIMS or H % Hkv or P % block_size \
            or k_pool.shape != (1, P, Hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention kernel needs hd in {HEAD_DIMS}, "
                         f"H % Hkv == 0 and whole blocks; got "
                         f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"block_size {block_size}")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B:
        raise ValueError("paged_attention: block_table must be int32 [B, n]")
    for t in (q, k_pool, v_pool, block_table):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous "
                             "tensors on q's device")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: q and the pools must start on "
                         "16 bytes (the kernel copies 16-byte chunks)")
    plan = launch_plan(B, S, H, Hkv, hd, q.dtype, block_table.shape[1],
                       block_size, _sm_count(q.device))
    cl = _lengths(cache_len, B, q.device)
    out = torch.empty_like(q)
    ws = tickets = None
    if plan.n_splits > 1:          # the partials (acc, m, l) of every span
        ws = torch.empty(plan.ctas * plan.qt * (hd + 2),
                         dtype=torch.float32, device=q.device)
        tickets = _ticket_buffer(q.device, plan.ctas // plan.n_splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(_DTYPES[q.dtype], int(plan.tensor_cores), plan.qt,
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_table.data_ptr(), cl.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                B, S, H, Hkv, hd, block_size, block_table.shape[1],
                plan.n_tiles, plan.n_splits, plan.span, float(softcap),
                float(hd ** -0.5), stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0     # kernel launches (CUDA tensors only)
