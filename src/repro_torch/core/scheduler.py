"""HarMoEny token scheduling (paper Alg. 2) + baseline policies.

Port of ``repro/core/scheduler.py``.  ``S[g_from, e, g_to]`` counts the
routable units (token, expert-choice) sent from source rank ``g_from`` for
expert ``e`` to destination rank ``g_to``.  Every policy is a replicated
deterministic function of the all-gathered counts, and every policy
conserves ``S.sum(axis=2) == counts``.

The greedy rebalance loop (Alg. 2) is a data-dependent loop of scalar
decisions over a ``[G, Ep, G]`` tensor of a few kB, which JAX runs inside
its jitted step as a ``lax.while_loop``.  Here it is a one-CTA CUDA
kernel on the card (``kernels/schedule``: S and the diagnostics never
leave the device, so the decode step can be captured as a CUDA graph) and
its plain numpy version on the CPU, both in exact integer arithmetic with
the JAX version's ``max_iters`` bound and its argmax/argmin first-index
tie rules, so ``S`` and the diagnostics equal the JAX schedule integer
for integer.  The topology's tables come from ``device_tables``, built
once per device.

Two per-call masks move the serving-time expert placement into the
schedule: ``extra_local`` [G, Ep] (replica slots: a source keeps its own
units home for an expert it holds a replica of, and the rebalancer
counts replica holders as local destinations) and ``non_local`` [G, Ep]
(tiered residency: statically placed experts swapped out of the device's
working set count as foreign).  The mask the kernel reads is built on the
device every call, ``(static local | extra_local) & ~non_local``; the
baselines ignore both.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.topology import EPTopology, device_tables
from repro_torch.kernels.schedule import ops as schedule_ops


class ScheduleDiag(NamedTuple):
    iters: torch.Tensor          # rebalance iterations executed
    moved: torch.Tensor          # total units moved
    max_load_before: torch.Tensor
    max_load_after: torch.Tensor


def initial_assign(counts: torch.Tensor, topo: EPTopology,
                   extra_local: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Alg. 1 line 11: route every unit to its expert's host.  counts
    [G, Ep] int32 -> S [G, Ep, G] int32; replicated experts (E < G) split
    their load evenly over the host replicas (remainder to the first).
    ``extra_local`` [G, Ep] bool marks replica-slot residencies: a source
    holding expert e in a replica slot keeps its own units for e."""
    G, Ep = topo.num_ranks, topo.padded_experts
    dev = counts.device
    if extra_local is not None:
        keep = counts * extra_local.to(counts.dtype)
        counts = counts - keep
    onehot = device_tables(topo, dev).host_onehot  # [r, Ep, G]
    S = torch.zeros((G, Ep, G), dtype=torch.int32, device=dev)
    base = counts // topo.hosts_per_expert
    rem = counts % topo.hosts_per_expert
    for i in range(topo.hosts_per_expert):
        share = base + (rem > i).to(torch.int32)
        S = S + share[:, :, None] * onehot[i][None, :, :]
    if extra_local is not None:
        eye = torch.eye(G, dtype=torch.int32, device=dev)
        S = S + keep[:, :, None] * eye[:, None, :]
    return S


def local_mask(topo: EPTopology, device,
               extra_local: Optional[torch.Tensor] = None,
               non_local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The [G, Ep] int32 mask of free destinations the Alg. 2 kernel
    reads: the static placement, widened by ``extra_local`` and then
    narrowed by ``non_local`` (both bool, built on the device)."""
    is_local = device_tables(topo, device).is_local
    if extra_local is not None:
        is_local = is_local | extra_local.to(torch.int32)
    if non_local is not None:
        is_local = is_local & (~non_local).to(torch.int32)
    return is_local


def even_split(counts: torch.Tensor, topo: EPTopology) -> torch.Tensor:
    """§5.3.2 Even-Split policy: each expert's units split over all G."""
    G = topo.num_ranks
    base = counts // G
    rem = counts % G
    h = torch.arange(G, dtype=torch.int32, device=counts.device)
    return base[:, :, None] + (h[None, None, :] < rem[:, :, None]).to(
        torch.int32)


def rebalance(S_initial: torch.Tensor, topo: EPTopology, *, q: int,
              c_pair: int, num_foreign_slots: int, max_iters: int = 128,
              extra_local: Optional[torch.Tensor] = None,
              non_local: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, ScheduleDiag]:
    """Alg. 2 greedy token rebalancing.  Two criteria, repaired by the
    same move (g_from, e_max, g_hot) -> (g_from, e_max, g_min):
      A. an off-diagonal pair exceeds ``c_pair`` (takes priority, ignores
         the q-threshold);
      B. a destination exceeds the average load t_avg (guarded by q).
    ``extra_local`` / ``non_local``: the per-call masks (module
    docstring).  The kernel on CUDA, the plain version on the CPU
    (``kernels.schedule``)."""
    S, d = schedule_ops.rebalance(
        S_initial.to(torch.int32).contiguous(),
        local_mask(topo, S_initial.device, extra_local, non_local),
        q=q, c_pair=c_pair, num_foreign_slots=num_foreign_slots,
        max_iters=max_iters)
    return S, ScheduleDiag(d[0], d[1], d[2], d[3])


def schedule(counts: torch.Tensor, topo: EPTopology, *, policy: str, q: int,
             c_pair: int, num_foreign_slots: int, max_iters: int = 128,
             extra_local: Optional[torch.Tensor] = None,
             non_local: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, ScheduleDiag]:
    """counts [G, Ep] -> (S [G, Ep, G], diagnostics) under ``policy``:
    harmoeny | round_robin | even_split | static_opt (the last differs
    only by the placement baked into ``topo``).  Only harmoeny reads
    ``extra_local`` and ``non_local``."""
    if policy == "harmoeny":
        S0 = initial_assign(counts, topo, extra_local=extra_local)
        return rebalance(S0, topo, q=q, c_pair=c_pair,
                         num_foreign_slots=num_foreign_slots,
                         max_iters=max_iters, extra_local=extra_local,
                         non_local=non_local)
    S0 = initial_assign(counts, topo)
    t0 = S0.sum(dim=(0, 1)).max()
    zero = torch.zeros((), dtype=torch.int32, device=counts.device)
    if policy in ("round_robin", "static_opt"):
        return S0, ScheduleDiag(zero, zero, t0, t0)
    if policy == "even_split":
        S = even_split(counts, topo)
        return S, ScheduleDiag(zero, zero, t0, S.sum(dim=(0, 1)).max())
    raise ValueError(f"unknown policy {policy!r}")
