"""Foreign-expert weight fetch (paper §4.3).

Port of ``repro/core/prefetch.py`` (``all_foreign_ids``,
``fetch_foreign_weights``, ``gather_all_experts``).  Every rank computes
every destination's foreign-expert ids (FIDS) from the replicated
schedule, and the fetch is one collective of its own, ``fetch_rows``
(``dispatch.py``), which each communicator answers with this rank's K
foreign rows in the form its transport does best: zeros at G = 1
(``LocalComm``), one gather from the rank-major weight on virtual ranks
(``VirtualGroup``), and across processes (``DistComm``) either the JAX
form, a [G, K] outbox per source through an even all-to-all, chunked
along the last dimension by ``fetch_chunk`` as in JAX, or only the
hosted rows through an uneven one.  All give the JAX function's values:
the hosting slot's row over ``hosts_per_expert``, zeros for -1.  The
JAX version builds each outbox as a mask einsum over all local experts
(``prefetch.py:84``); the port's dense form is an index gather with the
same values.

On the card the communicator issues the fetch on its side stream and the
MoE block joins it (``join``) just before the grouped FFN, so the fetch
overlaps the dispatch in between: the paper's dedicated CUDA stream,
which XLA's latency-hiding scheduler gives the JAX package.  The fetch
and the gather are body generators (collectives are yielded to the
communicator).

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

from repro_torch.core.dispatch import (Collective, Fetched, all_gather,
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
                          me: int, topo: EPTopology, fetch_chunk: int = 0):
    """w_local [epr, ...] (this rank's expert rows) -> a ``Fetched`` of
    this rank's [K, ...] foreign weights (``join`` waits for them).
    fids_all: FIDS [G, K] replicated; ``fetch_chunk`` > 0 chunks the
    dense form's last dimension."""
    return (yield Collective("fetch_rows", w_local,
                             (fids_all, me, topo, fetch_chunk)))


def join(fetched: Fetched) -> torch.Tensor:
    """The fetched rows, once the current stream has waited for the
    fetch's side stream; the rows' memory is kept from reuse until the
    current stream's work on them is done."""
    if fetched.done is not None:
        cur = torch.cuda.current_stream(fetched.rows.device)
        cur.wait_event(fetched.done)
        fetched.rows.record_stream(cur)
    return fetched.rows


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
