"""Foreign-expert weight fetch (paper §4.3).

Port of ``repro/core/prefetch.py`` (``all_foreign_ids``,
``fetch_foreign_weights``, ``gather_all_experts``).  Every rank computes
every destination's foreign-expert ids from the replicated schedule; each
source fills, for each destination, the K slots it hosts, and one
all-to-all delivers them.  The fetch and the gather are body generators
(``dispatch.py``: collectives are yielded to the communicator).

The JAX version builds each source's outbox as a mask einsum over ALL of
its local experts (``prefetch.py:84``).  At G = 1 every expert is local,
the ids are all -1 and the result is zeros, yet the einsum reads every
expert's matrices (~1 GB per layer at qwen15-moe-a27b's width).  The port
computes the same function as an index gather: the hosting slot's row
divided by ``hosts_per_expert``, zeros for -1 — K rows read, not all.
The slot tables are the topology's cached device tables
(``topology.device_tables``).

Tiered residency (``serve/residency.py``): the serve engine keeps a
``[G, W]`` table of each rank's device-resident working set, which rides
into the decode step in a static device buffer; ``residency_non_local``
turns it into the scheduler's ``non_local`` mask, and
``stage_expert_rows`` writes staged rows into a weight leaf in place,
one copy a row (host to device over PCIe when the rows come from the
pinned host tier).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.dispatch import (all_gather, all_to_all,
                                       replica_slot_map)
from repro_torch.core.topology import EPTopology, device_tables


def all_foreign_ids(S: torch.Tensor, topo: EPTopology,
                    num_foreign_slots: int,
                    replica_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """FIDS [G, K]: the k-th foreign expert of each destination (-1 = none),
    a pure function of the replicated schedule S [G, Ep, G] and, with
    hot-expert replication, of the replica table ``replica_ids`` [G, R]:
    an expert held in a destination's replica slot is not fetched."""
    G, Ep = topo.num_ranks, topo.padded_experts
    K = num_foreign_slots
    dev = S.device
    tok_e = S.sum(dim=0)                                     # [Ep, G_dst]
    lsl = device_tables(topo, dev).local_slot_of             # [G, Ep]
    active = (tok_e.T > 0) & (lsl < 0)
    if replica_ids is not None:
        active = active & (replica_slot_map(replica_ids, Ep) < 0)
    f_rank = torch.cumsum(active.to(torch.int32), dim=1) - 1
    scatter = torch.where(active, torch.clamp(f_rank, max=K), K)
    fids = torch.full((G, K + 1), -1, dtype=torch.int32, device=dev)
    src = torch.arange(Ep, dtype=torch.int32, device=dev).expand(G, Ep)
    fids.scatter_(1, scatter.long(), src)     # duplicates only at column K
    return fids[:, :K]


def fetch_foreign_weights(w_local: torch.Tensor, fids_all: torch.Tensor,
                          me: int, topo: EPTopology):
    """w_local [epr, ...] (this rank's expert rows) -> [K, ...] foreign
    weights for this rank.  fids_all: FIDS [G, K] replicated."""
    slot_of = device_tables(topo, w_local.device).local_slot_of[me]
    slot = torch.where(fids_all >= 0,
                       slot_of[torch.clamp(fids_all, min=0).long()], -1)
    hosted = (slot >= 0).to(w_local.dtype) / topo.hosts_per_expert
    idx = torch.clamp(slot, min=0).long()                    # [G, K]
    extra = (1,) * (w_local.ndim - 1)
    out = w_local[idx] * hosted.reshape(hosted.shape + extra)  # [G_dst, K, ...]
    ret = yield from all_to_all(out)                         # [G_src, K, ...]
    return ret.sum(dim=0)                                    # sum over sources


def residency_non_local(residency_ids: torch.Tensor,
                        topo: EPTopology) -> torch.Tensor:
    """Residency table [G, W] (-1 pads) -> the scheduler's ``non_local``
    mask [G, Ep] bool: experts statically placed on rank g but not in its
    current working set.  A value function of the table on the device."""
    resident = replica_slot_map(residency_ids, topo.padded_experts) >= 0
    static = device_tables(topo, residency_ids.device).is_local != 0
    return static & ~resident


def stage_expert_rows(w: torch.Tensor, rows: Sequence[int],
                      vals: torch.Tensor) -> torch.Tensor:
    """Write staged expert rows into the weight leaf ``w`` [..., rows, d,
    f] in place and return it.  ``rows`` [n] are host row indices (a
    stage copies a different number of rows each time, so it is never
    captured), ``vals`` the staged values in ``w``'s layout with the row
    axis (third from last) sized n.  Each row is one copy; from pinned
    host memory to the card it is asynchronous on the current stream.
    Duplicate rows carry identical values."""
    axis = w.ndim - 3
    for i, r in enumerate(int(r) for r in rows):
        w.select(axis, r).copy_(vals.select(axis, i), non_blocking=True)
    return w


def gather_all_experts(w_local: torch.Tensor):
    """Even-Split support (paper §5.3.2): every rank's expert rows, in
    rank-major order [G * epr, ...].  On a ``VirtualGroup`` this is a view
    of the rank-major weight, not a copy."""
    w_all = yield from all_gather(w_local)
    return w_all.reshape((-1,) + tuple(w_local.shape[1:]))
