"""Alg. 2 (greedy token rebalancing): the CUDA kernel's wrapper and its
plain version.

Port of the loop of ``repro/core/scheduler.py::rebalance``, which JAX
runs inside the jitted step as a ``lax.while_loop``.  ``rebalance``
launches the one-CTA kernel of ``csrc/schedule.cu`` for CUDA tensors and
runs ``rebalance_plain`` for CPU tensors; there is no fallback from one to
the other.  On the card the schedule never leaves the device, so a step
that schedules can be captured as a CUDA graph.

``rebalance.launches`` counts the kernel's launches (CUDA tensors only).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

_INT_MAX = np.iinfo(np.int32).max
SMEM_LIMIT = 48 * 1024     # the kernel's shared memory without an opt-in
STOPS = ("balanced", "stop_q", "none_allowed", "g_min_is_hot", "t_s",
         "stop_cap", "max_iters")


def _rebalance_np(S0: np.ndarray, is_local: np.ndarray, *, q: int,
                  c_pair: int, num_foreign_slots: int, max_iters: int):
    """The loop in exact integer arithmetic on the host: (S, iters,
    moved, max_load_before, max_load_after, stops, pair_branch), where
    ``stops`` names every condition that held when it ended (``STOPS``;
    g_min == g_hot only ever holds beside none_allowed) and
    ``pair_branch`` says whether an iteration took the pair-capacity
    criterion (A)."""
    G = S0.shape[0]
    S = S0.astype(np.int64)
    offdiag = 1 - np.eye(G, dtype=np.int64)
    t_avg = S.sum() // G                                         # line 4
    before = S.sum(axis=(0, 1)).max()
    foreign = np.zeros(is_local.shape, bool)
    it = moved = 0
    stops, pair_branch = ("max_iters",), False
    while it < max_iters:
        t_g = S.sum(axis=(0, 1))                                 # line 5
        pair = S.sum(axis=1)                                     # [G_src, G_dst]
        over_pair = pair * offdiag - c_pair
        has_pair_over = bool((over_pair > 0).any())
        if not (bool((t_g > t_avg).any()) or has_pair_over):     # line 6
            stops = ("balanced",)
            break
        it += 1
        pair_branch |= has_pair_over
        flat = int(np.argmax(over_pair))
        if has_pair_over:
            g_from, g_hot = flat // G, flat % G
        else:
            g_hot = int(np.argmax(t_g))                          # line 7
            g_from = int(np.argmax(pair[:, g_hot]))              # line 8
        col = S[g_from, :, g_hot]
        e_max = int(np.argmax(col))                              # line 9
        t_move = int(col[e_max])                                 # line 11
        n_foreign = foreign.sum(axis=1)
        slot_ok = (is_local[:, e_max] | foreign[:, e_max]
                   | (n_foreign < num_foreign_slots))
        pair_slack = np.where(np.arange(G) == g_from, _INT_MAX,
                              c_pair - pair[g_from])
        allowed = slot_ok & (pair_slack > 0)
        allowed[g_hot] = False
        g_min = int(np.argmin(np.where(allowed, t_g, _INT_MAX)))  # line 15
        headroom = t_avg - t_g[g_min] + (q if has_pair_over else 0)
        t_s = min(t_move, headroom, int(pair_slack[g_min]))
        if has_pair_over:
            t_s = min(t_s, max(int(over_pair[g_from, g_hot]), 0))
        held = {
            "stop_q": (not has_pair_over) and t_move < q,        # line 12
            "none_allowed": not allowed.any(),
            "g_min_is_hot": g_min == g_hot,
            "t_s": t_s <= 0,
            "stop_cap": (not has_pair_over)                      # line 16
                        and (t_g[g_min] + q > t_avg),
        }
        if any(held.values()):
            stops = tuple(name for name, h in held.items() if h)
            break
        S[g_from, e_max, g_hot] -= t_s                           # lines 20-23
        S[g_from, e_max, g_min] += t_s
        foreign[g_min, e_max] |= not is_local[g_min, e_max]
        moved += t_s
    after = S.sum(axis=(0, 1)).max()
    return (S.astype(np.int32), it, moved, int(before), int(after), stops,
            pair_branch)


def rebalance_plain(S_initial: torch.Tensor, is_local: torch.Tensor, *,
                    q: int, c_pair: int, num_foreign_slots: int,
                    max_iters: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function on the host (numpy): S [G, Ep, G] int32 and
    diag [4] int32 = (iters, moved, max_load_before, max_load_after), on
    the input's device."""
    S, it, moved, before, after, _, _ = _rebalance_np(
        S_initial.cpu().numpy(), is_local.cpu().numpy() != 0, q=q,
        c_pair=c_pair, num_foreign_slots=num_foreign_slots,
        max_iters=max_iters)
    dev = S_initial.device
    diag = np.array([it, moved, before, after], np.int32)
    return torch.from_numpy(S).to(dev), torch.from_numpy(diag).to(dev)


def smem_bytes(G: int, Ep: int) -> int:
    """The kernel's shared memory (``schedule_smem_bytes`` in the source)."""
    return (G * Ep * G + G + G * G + G) * 4 + 2 * G * Ep


def _lib():
    fn = build.load("schedule").schedule_rebalance_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def rebalance(S_initial: torch.Tensor, is_local: torch.Tensor, *, q: int,
              c_pair: int, num_foreign_slots: int, max_iters: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_initial [G, Ep, G] int32, is_local [G, Ep] int32 (1 where rank g
    hosts expert e) -> (S [G, Ep, G] int32, diag [4] int32), both on the
    input's device; never read on the host."""
    if S_initial.device.type == "cpu":
        return rebalance_plain(S_initial, is_local, q=q, c_pair=c_pair,
                               num_foreign_slots=num_foreign_slots,
                               max_iters=max_iters)
    if S_initial.device.type != "cuda":
        raise ValueError(f"rebalance runs on cuda or cpu, not "
                         f"{S_initial.device}")
    G, Ep, G2 = S_initial.shape
    if G2 != G or tuple(is_local.shape) != (G, Ep):
        raise ValueError(f"rebalance: S must be [G, Ep, G] and is_local "
                         f"[G, Ep]; got {tuple(S_initial.shape)} and "
                         f"{tuple(is_local.shape)}")
    for t in (S_initial, is_local):
        if t.dtype != torch.int32 or t.device != S_initial.device \
                or not t.is_contiguous():
            raise ValueError("rebalance: S and is_local must be contiguous "
                             "int32 tensors on one device")
    if smem_bytes(G, Ep) > SMEM_LIMIT:
        raise ValueError(f"rebalance: a schedule of G={G}, Ep={Ep} needs "
                         f"{smem_bytes(G, Ep)} bytes of shared memory, "
                         f"above the kernel's {SMEM_LIMIT}")
    S = torch.empty_like(S_initial)
    diag = torch.empty((4,), dtype=torch.int32, device=S.device)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = _lib()(S_initial.data_ptr(), is_local.data_ptr(), S.data_ptr(),
                diag.data_ptr(), G, Ep, int(q), int(c_pair),
                int(num_foreign_slots), int(max_iters), stream)
    build.check(rc, "schedule")
    rebalance.launches += 1
    return S, diag


rebalance.launches = 0     # kernel launches (CUDA tensors only)
