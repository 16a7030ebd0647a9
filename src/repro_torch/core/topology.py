"""Expert-parallel topology: static expert placement and slot maps.

Port of ``repro/core/topology.py`` (``make_topology``, ``local_slot_of``,
``static_opt_placement``).
Ranks are positions in the expert-parallel group.  Experts are padded to a
multiple of the EP degree so every rank owns the same number of local
slots; padded (dummy) experts are never routed to.

``make_topology`` returns one shared ``EPTopology`` per (G, E, placement),
and ``device_tables`` its static index tables as device tensors, built
once per (topology, device) and read by every step after: a captured
decode step may copy nothing from the host (``serve/stepcore.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

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

    @property
    def is_replicated(self) -> bool:
        return self.hosts_per_expert > 1


def make_topology(num_ranks: int, num_experts: int,
                  placement=None) -> EPTopology:
    """Round-robin placement (expert e on rank ``e % G``) when E >= G;
    each expert replicated on ``G // E`` ranks when E < G.  ``placement``
    optionally permutes experts onto slots.  Equal arguments give the same
    (shared, read-only) object."""
    perm = None if placement is None else tuple(
        int(p) for p in np.asarray(placement).reshape(-1))
    return _make_topology(int(num_ranks), int(num_experts), perm)


@functools.lru_cache(maxsize=None)
def _make_topology(G: int, E: int, placement) -> EPTopology:
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


class TopoTables(NamedTuple):
    """A topology's static tables on one device."""
    local_slot_of: torch.Tensor   # [G, Ep] int32, ``local_slot_of(topo)``
    is_local: torch.Tensor        # [G, Ep] int32, 1 where rank g hosts e
    slot_map: torch.Tensor        # [G, epr] int32
    host_onehot: torch.Tensor     # [hosts_per_expert, Ep, G] int32
    expert_row: torch.Tensor      # [Ep] int64, expert -> first global slot row


_tables: Dict[Tuple[int, torch.device], Tuple[EPTopology, TopoTables]] = {}


def device_tables(topo: EPTopology, device) -> TopoTables:
    """``topo``'s tables on ``device``, copied from the host on first use
    and cached.  Raises if that first use is inside a CUDA-graph capture,
    which cannot copy from pageable host memory: the eager warm step
    before a capture builds them."""
    device = torch.device(device)
    key = (id(topo), device)
    hit = _tables.get(key)
    if hit is not None and hit[0] is topo:
        return hit[1]
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("device_tables: first use inside a CUDA-graph "
                           "capture; run the step once eagerly first")
    G, Ep = topo.num_ranks, topo.padded_experts
    lso = local_slot_of(topo)
    onehot = np.zeros((topo.hosts_per_expert, Ep, G), np.int32)
    for i in range(topo.hosts_per_expert):
        onehot[i, np.arange(Ep), topo.host_of[:, i]] = 1
    rows = np.zeros((Ep,), np.int64)
    for g in range(G):
        for j in range(topo.experts_per_rank):
            rows[topo.slot_map[g, j]] = g * topo.experts_per_rank + j

    def dev(a):
        return torch.as_tensor(a, device=device)
    tables = TopoTables(dev(lso), dev((lso >= 0).astype(np.int32)),
                        dev(topo.slot_map), dev(onehot), dev(rows))
    _tables[key] = (topo, tables)
    return tables


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
