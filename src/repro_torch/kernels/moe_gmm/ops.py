"""Grouped expert FFN: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/moe_gmm/`` (``moe_gmm``, ``ops.fused_expert_ffn``,
``ref.moe_gmm_ref``).  ``moe_gmm`` launches the hand-written kernel in
``csrc/moe_gmm.cu`` for CUDA tensors and runs ``moe_gmm_plain`` for CPU
tensors; there is no fallback from one to the other.

Weights come as ``G0`` local groups plus, optionally, ``replica`` — the
``R`` replica-slot groups that follow them (hot experts' copies,
``serve/rebalance.py``) — and ``foreign`` — the ``K`` fetched foreign
groups after those — so the caller never concatenates them into one
copy.

The kernel's design is chosen by ``x.dtype``, explicitly (no input can
reach both): bfloat16, the main paths' type, runs on the tensor cores
(``wgmma``) and needs ``block_m % 64 == 0``; float32 runs on the CUDA
cores, since ``wgmma``'s only f32 route is TF32.  Tiles of zero rows give
exact zeros (act(0) = 0), and the dispatch buffer's padding rows are zeros
by construction.  The bf16 kernel learns which tiles are live from
``live_rows`` (``live_row_count``: every tile at or past it is zero rows)
and skips the rest; without it every tile is live.  The f32 kernel finds
the non-zero 32-row sub-tiles with a flag pass over ``x``.

Counters, advanced only where the kernel launches: ``moe_gmm.launches``,
and the real rows of the foreign groups that went through the kernel
(the caller's ``foreign_rows``), added in place to one device
accumulator per device, so counting never waits on the card and a
captured step's replays add to it too (``foreign_rows_total``,
``reset_foreign_rows``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_ACTS = {"silu": 0, "gelu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Foreign = Optional[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]


def tile_group_map(group_sizes_padded: torch.Tensor, n_tiles: int,
                   block_m: int) -> torch.Tensor:
    """tile index -> group id from block-aligned group extents.  Tiles
    beyond the last group clamp to the final group (their rows are zeros)."""
    offsets = torch.cumsum(group_sizes_padded, 0).to(torch.int32)
    starts = torch.arange(n_tiles, dtype=torch.int32,
                          device=group_sizes_padded.device) * block_m
    tg = torch.searchsorted(offsets, starts, right=True).to(torch.int32)
    return torch.clamp(tg, max=group_sizes_padded.shape[0] - 1)


def live_row_count(group_sizes_padded: torch.Tensor, M: int) -> torch.Tensor:
    """min(sum(group_sizes_padded), M) as a one-element int32 tensor on the
    extents' device, without a host sync.  Extents are rounded up to
    block_m, so every tile below the count holds a real row, and every row
    at or past it is zero (rows past ``c_total`` were dropped, though
    ``group_sizes`` still counts them: hence the ``min``)."""
    return torch.clamp(group_sizes_padded.sum(), max=M).to(
        torch.int32).reshape(1)


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    if name == "relu":
        return F.relu(h)
    if name == "silu":
        return F.silu(h)
    raise ValueError(name)


def _with_foreign(w_in, w_out, w_gate, replica: Foreign, foreign: Foreign):
    """The three sources concatenated in group order: local | replica |
    foreign."""
    for extra in (replica, foreign):
        if extra is None:
            continue
        ei, eo, eg = extra
        w_in, w_out = torch.cat([w_in, ei]), torch.cat([w_out, eo])
        w_gate = None if w_gate is None else torch.cat([w_gate, eg])
    return w_in, w_out, w_gate


def moe_gmm_plain(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                  tile_group: torch.Tensor, *,
                  w_gate: Optional[torch.Tensor] = None, act: str = "silu",
                  block_m: int = 128, replica: Foreign = None,
                  foreign: Foreign = None,
                  live_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per tile, f32 products, the
    activation in f32, h rounded to x's type before the second product.
    Every tile is computed: ``live_rows`` only promises that the rows at
    or past it are zero, whose output is zero either way."""
    w_in, w_out, w_gate = _with_foreign(w_in, w_out, w_gate, replica,
                                        foreign)
    M, d = x.shape
    tg = tile_group.long()
    xt = x.reshape(M // block_m, block_m, d).float()
    h = torch.bmm(xt, w_in[tg].float())
    if w_gate is not None:
        h = F.silu(torch.bmm(xt, w_gate[tg].float())) * h
    else:
        h = _act(act, h)
    y = torch.bmm(h.to(x.dtype).float(), w_out[tg].float())
    return y.reshape(M, d).to(x.dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _lib():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, p, p, p, p, p, p, p, p, p, p, i, i, p, p,
                       p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_in, w_out, w_gate, foreign, tile_group, act, block_m,
           live_rows=None, replica=None):
    M, d = x.shape
    G0, d_w, f = w_in.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm takes float32 or bfloat16, not {x.dtype}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    mats = ([w_in, w_out, w_gate] + (list(replica) if replica else [])
            + (list(foreign) if foreign else []))
    for t in [x, tile_group, live_rows] + mats:
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe_gmm: every operand must be a contiguous "
                             "tensor on x's device")
    for t in mats:
        if t is not None and t.dtype != x.dtype:
            raise TypeError("moe_gmm: weights must have x's dtype")
    if d_w != d or w_out.shape != (G0, f, d) or (
            w_gate is not None and w_gate.shape != w_in.shape):
        raise ValueError("moe_gmm: weight shapes disagree with x")
    for what, extra in (("replica", replica), ("foreign", foreign)):
        if extra is None:
            continue
        ei, eo, eg = extra
        n = ei.shape[0]
        if ei.shape != (n, d, f) or eo.shape != (n, f, d) or (
                (eg is None) != (w_gate is None)
                or (eg is not None and eg.shape != ei.shape)):
            raise ValueError(f"moe_gmm: {what} weight shapes disagree")
    if tile_group.dtype != torch.int32 or tile_group.shape != (M // block_m,):
        raise ValueError("moe_gmm: tile_group must be int32 [M // block_m]")
    if live_rows is not None and (live_rows.dtype != torch.int32
                                  or live_rows.shape != (1,)):
        raise ValueError("moe_gmm: live_rows must be int32 [1]")
    if M % block_m or block_m % 32 or d % 64 or f % 64:
        raise ValueError(f"moe_gmm kernel needs M % block_m == 0, block_m % "
                         f"32 == 0, d % 64 == 0 and f % 64 == 0; got M={M}, "
                         f"block_m={block_m}, d={d}, f={f}")
    if x.dtype == torch.bfloat16 and block_m % 64:
        raise ValueError(f"moe_gmm's bf16 kernel needs block_m % 64 == 0 "
                         f"(64-row warpgroup tiles); got block_m={block_m}")


def moe_gmm(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
            tile_group: torch.Tensor, *, w_gate: Optional[torch.Tensor] = None,
            act: str = "silu", block_m: int = 128, replica: Foreign = None,
            foreign: Foreign = None,
            live_rows: Optional[torch.Tensor] = None,
            foreign_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, d]; w_in/w_gate [G0, d, f]; w_out [G0, f, d]; ``replica`` an
    optional (w_in, w_out, w_gate) of R more groups and ``foreign`` one of
    K groups after those; tile_group [M // block_m] int32 in [0, G0 + R +
    K); ``live_rows`` an optional int32 [1] on x's device, a multiple of
    block_m, past which every row of x is zero; ``foreign_rows`` the
    foreign groups' real row count, for the counter -> [M, d] in x's
    type.  Forward only: raises when an input requires grad under grad
    mode (``build.forward_only``), on either device."""
    build.forward_only("moe_gmm", x, w_in, w_out, w_gate,
                       *(replica or ()), *(foreign or ()))
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w_in, w_out, tile_group, w_gate=w_gate,
                             act=act, block_m=block_m, replica=replica,
                             foreign=foreign, live_rows=live_rows)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cuda or cpu, not {x.device}")
    _check(x, w_in, w_out, w_gate, foreign, tile_group, act, block_m,
           live_rows, replica)
    M, d = x.shape
    f = w_in.shape[2]
    ri, ro, rg = replica if replica is not None else (None, None, None)
    n_rep = 0 if ri is None else ri.shape[0]
    fi, fo, fg = foreign if foreign is not None else (None, None, None)
    h = torch.empty((M, f), dtype=x.dtype, device=x.device)
    y = torch.empty((M, d), dtype=x.dtype, device=x.device)
    # the f32 kernel's flag pass writes one int per 32-row sub-tile
    live = (torch.empty((M // 32,), dtype=torch.int32, device=x.device)
            if x.dtype == torch.float32 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(_DTYPES[x.dtype], int(w_gate is not None), _ACTS[act],
                x.data_ptr(), w_in.data_ptr(), _ptr(w_gate), w_out.data_ptr(),
                _ptr(ri), _ptr(rg), _ptr(ro), _ptr(fi), _ptr(fg), _ptr(fo),
                w_in.shape[0], n_rep, tile_group.data_ptr(), _ptr(live), _ptr(live_rows),
                h.data_ptr(), y.data_ptr(), M, d, f, block_m, stream)
    build.check(rc, "moe_gmm")
    moe_gmm.launches += 1
    if foreign is not None and foreign_rows is not None:
        _foreign_acc(x.device).add_(foreign_rows.reshape(()))
    return y


moe_gmm.launches = 0     # kernel launches (CUDA tensors only)

# foreign-group rows through those launches, one int64 scalar per device
_foreign: Dict[torch.device, torch.Tensor] = {}


def _foreign_acc(device: torch.device) -> torch.Tensor:
    acc = _foreign.get(device)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_gmm: the foreign-row counter is made by "
                               "an eager launch, not inside a capture")
        acc = _foreign[device] = torch.zeros((), dtype=torch.int64,
                                             device=device)
    return acc


def reset_foreign_rows() -> None:
    """Set every device's foreign-row count to 0 (in place)."""
    for acc in _foreign.values():
        acc.zero_()


def foreign_rows_total() -> int:
    """Foreign-group rows through ``moe_gmm`` since the last reset, over
    every device (reads the counters on the host)."""
    return sum(int(acc) for acc in _foreign.values())


def fused_expert_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                     group_sizes_padded: torch.Tensor, *,
                     w_gate: Optional[torch.Tensor] = None, act: str = "silu",
                     block_m: int = 128, replica: Foreign = None,
                     foreign: Foreign = None,
                     foreign_rows: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Entry used by ``core/grouped_ffn.py``: block-aligned group extents
    -> tile map and live-row count -> ``moe_gmm``."""
    M = x.shape[0]
    tg = tile_group_map(group_sizes_padded, M // block_m, block_m)
    return moe_gmm(x, w_in, w_out, tg, w_gate=w_gate, act=act,
                   block_m=block_m, replica=replica, foreign=foreign,
                   live_rows=live_row_count(group_sizes_padded, M),
                   foreign_rows=foreign_rows)
