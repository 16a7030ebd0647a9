"""Expert-parallel topology: static expert placement and slot maps.

Port of ``repro/core/topology.py`` (``make_topology``, ``local_slot_of``,
``static_opt_placement``).
Ranks are positions in the expert-parallel group.  Experts are padded to a
multiple of the EP degree so every rank owns the same number of local
slots; padded (dummy) experts are never routed to.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import round_up


@dataclass(frozen=True)
class EPTopology:
    num_ranks: int            # G: EP degree
    num_experts: int          # E: real experts
    padded_experts: int       # Ep: round_up(E, G) when E >= G else E
    experts_per_rank: int     # local slots per rank
    hosts_per_expert: int     # replication factor (1 when E >= G)
    slot_map: np.ndarray      # [G, experts_per_rank] expert id of each local slot
    host_of: np.ndarray       # [Ep, hosts_per_expert] host ranks of each expert


def make_topology(num_ranks: int, num_experts: int,
                  placement: np.ndarray | None = None) -> EPTopology:
    """Round-robin placement (expert e on rank ``e % G``) when E >= G;
    each expert replicated on ``G // E`` ranks when E < G.  ``placement``
    optionally permutes experts onto slots."""
    G = int(num_ranks)
    E = int(num_experts)
    if E >= G:
        Ep = round_up(E, G)
        epr = Ep // G
        perm = np.arange(Ep) if placement is None else np.asarray(placement)
        assert perm.shape == (Ep,)
        slot_map = perm.reshape(epr, G).T.copy()          # [G, epr]
        host_of = np.zeros((Ep, 1), np.int64)
        for g in range(G):
            for j in range(epr):
                host_of[slot_map[g, j], 0] = g
        return EPTopology(G, E, Ep, epr, 1, slot_map.astype(np.int32),
                          host_of.astype(np.int32))
    if G % E != 0:
        raise ValueError(f"EP degree {G} must be a multiple of "
                         f"num_experts {E}")
    r = G // E
    slot_map = (np.arange(G) % E).reshape(G, 1)
    host_of = np.zeros((E, r), np.int64)
    for e in range(E):
        host_of[e] = np.arange(r) * E + e
    return EPTopology(G, E, E, 1, r, slot_map.astype(np.int32),
                      host_of.astype(np.int32))


def local_slot_of(topo: EPTopology) -> np.ndarray:
    """[G, Ep] -> local slot index of expert e on rank g, or -1 if not hosted."""
    out = -np.ones((topo.num_ranks, topo.padded_experts), np.int32)
    for g in range(topo.num_ranks):
        for j in range(topo.experts_per_rank):
            out[g, topo.slot_map[g, j]] = j
    return out


def static_opt_placement(profile_counts: np.ndarray,
                         num_ranks: int) -> np.ndarray:
    """ExFlow-like offline placement (the ``static_opt`` baseline): experts
    sorted by their profiled popularity ``profile_counts`` [E] are dealt
    into the G rank bins, each to the least-loaded bin with room (first
    index on ties).  Returns the permutation [Ep] with ``perm[j * G + g]``
    the expert in slot j of rank g, as ``make_topology``'s ``placement``."""
    E = profile_counts.shape[0]
    Ep = round_up(E, num_ranks)
    counts = np.zeros(Ep)
    counts[:E] = profile_counts
    order = np.argsort(-counts)                 # most popular first
    epr = Ep // num_ranks
    bins: list[list[int]] = [[] for _ in range(num_ranks)]
    loads = np.zeros(num_ranks)
    for e in order:
        g = int(np.argmin(loads))
        if len(bins[g]) >= epr:                 # full: least-loaded with room
            cand = [i for i in range(num_ranks) if len(bins[i]) < epr]
            g = cand[int(np.argmin(loads[cand]))]
        bins[g].append(int(e))
        loads[g] += counts[e]
    perm = np.zeros(Ep, np.int64)
    for g in range(num_ranks):
        for j in range(epr):
            perm[j * num_ranks + g] = bins[g][j]
    return perm
