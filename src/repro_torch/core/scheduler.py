"""HarMoEny token scheduling (paper Alg. 2) + baseline policies.

Port of ``repro/core/scheduler.py``.  ``S[g_from, e, g_to]`` counts the
routable units (token, expert-choice) sent from source rank ``g_from`` for
expert ``e`` to destination rank ``g_to``.  Every policy is a replicated
deterministic function of the all-gathered counts, and every policy
conserves ``S.sum(axis=2) == counts``.

The greedy rebalance loop (Alg. 2) is a data-dependent loop of scalar
decisions over a ``[G, Ep, G]`` tensor of a few kB.  It runs on the host
in exact integer arithmetic (numpy), with the JAX version's ``max_iters``
bound and its argmax/argmin first-index tie rules, so ``S`` and the
diagnostics equal the JAX schedule integer for integer.  When the initial
assignment is already balanced (always at G = 1) the loop body never runs
and ``S`` stays on the counts' device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.topology import EPTopology, local_slot_of

_INT_MAX = np.iinfo(np.int32).max


class ScheduleDiag(NamedTuple):
    iters: torch.Tensor          # rebalance iterations executed
    moved: torch.Tensor          # total units moved
    max_load_before: torch.Tensor
    max_load_after: torch.Tensor


def initial_assign(counts: torch.Tensor, topo: EPTopology) -> torch.Tensor:
    """Alg. 1 line 11: route every unit to its expert's host.  counts
    [G, Ep] int32 -> S [G, Ep, G] int32; replicated experts (E < G) split
    their load evenly over the host replicas (remainder to the first)."""
    G, Ep = topo.num_ranks, topo.padded_experts
    r = topo.hosts_per_expert
    S = torch.zeros((G, Ep, G), dtype=torch.int32, device=counts.device)
    base = counts // r
    rem = counts % r
    for i in range(r):
        onehot = np.zeros((Ep, G), np.int32)
        onehot[np.arange(Ep), topo.host_of[:, i]] = 1
        share = base + (rem > i).to(torch.int32)
        S = S + share[:, :, None] * torch.as_tensor(
            onehot, device=counts.device)[None, :, :]
    return S


def even_split(counts: torch.Tensor, topo: EPTopology) -> torch.Tensor:
    """§5.3.2 Even-Split policy: each expert's units split over all G."""
    G = topo.num_ranks
    base = counts // G
    rem = counts % G
    h = torch.arange(G, dtype=torch.int32, device=counts.device)
    return base[:, :, None] + (h[None, None, :] < rem[:, :, None]).to(
        torch.int32)


def _diag(device, iters, moved, before, after) -> ScheduleDiag:
    def t(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)
    return ScheduleDiag(t(iters), t(moved), t(before), t(after))


def rebalance(S_initial: torch.Tensor, topo: EPTopology, *, q: int,
              c_pair: int, num_foreign_slots: int,
              max_iters: int = 128) -> tuple[torch.Tensor, ScheduleDiag]:
    """Alg. 2 greedy token rebalancing.  Two criteria, repaired by the
    same move (g_from, e_max, g_hot) -> (g_from, e_max, g_min):
      A. an off-diagonal pair exceeds ``c_pair`` (takes priority, ignores
         the q-threshold);
      B. a destination exceeds the average load t_avg (guarded by q)."""
    dev = S_initial.device
    G = topo.num_ranks
    S = S_initial.cpu().numpy().astype(np.int64)
    is_local = local_slot_of(topo) >= 0                          # [G, Ep]
    offdiag = 1 - np.eye(G, dtype=np.int64)
    t_avg = S.sum() // G                                         # line 4
    before = S.sum(axis=(0, 1)).max()
    foreign = np.zeros(is_local.shape, bool)
    it = moved = 0
    while it < max_iters:
        t_g = S.sum(axis=(0, 1))                                 # line 5
        pair = S.sum(axis=1)                                     # [G_src, G_dst]
        over_pair = pair * offdiag - c_pair
        has_pair_over = bool((over_pair > 0).any())
        if not (bool((t_g > t_avg).any()) or has_pair_over):     # line 6
            break
        it += 1
        flat = int(np.argmax(over_pair))
        if has_pair_over:
            g_from, g_hot = flat // G, flat % G
        else:
            g_hot = int(np.argmax(t_g))                          # line 7
            g_from = int(np.argmax(pair[:, g_hot]))              # line 8
        col = S[g_from, :, g_hot]
        e_max = int(np.argmax(col))                              # line 9
        t_move = int(col[e_max])                                 # line 11
        stop_q = (not has_pair_over) and t_move < q              # line 12
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
        stop_cap = (not has_pair_over) and (t_g[g_min] + q > t_avg)  # line 16
        if (stop_q or not allowed.any() or g_min == g_hot or t_s <= 0
                or stop_cap):
            break
        S[g_from, e_max, g_hot] -= t_s                           # lines 20-23
        S[g_from, e_max, g_min] += t_s
        foreign[g_min, e_max] |= not is_local[g_min, e_max]
        moved += t_s
    after = S.sum(axis=(0, 1)).max()
    S_out = S_initial if moved == 0 else torch.as_tensor(
        S.astype(np.int32), device=dev)
    return S_out, _diag(dev, it, moved, before, after)


def schedule(counts: torch.Tensor, topo: EPTopology, *, policy: str, q: int,
             c_pair: int, num_foreign_slots: int,
             max_iters: int = 128) -> tuple[torch.Tensor, ScheduleDiag]:
    """counts [G, Ep] -> (S [G, Ep, G], diagnostics) under ``policy``:
    harmoeny | round_robin | even_split | static_opt (the last differs
    only by the placement baked into ``topo``)."""
    S0 = initial_assign(counts, topo)
    if policy == "harmoeny":
        return rebalance(S0, topo, q=q, c_pair=c_pair,
                         num_foreign_slots=num_foreign_slots,
                         max_iters=max_iters)
    t0 = S0.sum(dim=(0, 1)).max()
    zero = torch.zeros((), dtype=torch.int32, device=counts.device)
    if policy in ("round_robin", "static_opt"):
        return S0, ScheduleDiag(zero, zero, t0, t0)
    if policy == "even_split":
        S = even_split(counts, topo)
        return S, ScheduleDiag(zero, zero, t0, S.sum(dim=(0, 1)).max())
    raise ValueError(f"unknown policy {policy!r}")
