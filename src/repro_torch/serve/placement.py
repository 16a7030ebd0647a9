"""The device side of the serving-time expert placement (paper §4.2-4.3):
the replica swap and the pinned host tier that residency stages from.

The policies are host numpy (``serve/rebalance.py``,
``serve/residency.py``); what they decide is carried out here, on the
tensors the engine's captured steps read, always in place, so the graphs
captured on those tensors stay valid:

* ``ReplicaSwap`` gathers the ``G * R`` hot rows named by a
  ``RebalanceDecision`` into every MoE layer's ``w_rep_*`` leaves, a
  device-to-device gather whose rows sit in a static device buffer
  (``stepcore.Staged``).  On the card it is captured once as a CUDA graph
  (``stepcore.Entry``, the JAX engine's jitted ``_swap_fn``) and replayed
  for every later swap.  Across processes (``dispatch.DistComm``, where a
  process holds only its own expert rows and its own R slots) each slot's
  row comes from the process that hosts it: the swap is the
  communicator's foreign fetch with the ``[G, R]`` replica table in place
  of FIDS, into the replica leaves instead of a transient buffer
  (JAX's ``jnp.take`` over the sharded weights gathers across devices
  the same way).  Its dense form is captured as on one process (NCCL);
  its hosted form moves only the hot rows and runs eagerly (gloo).
* ``HostTier`` holds every expert weight row in host memory: one buffer a
  row of the rank-major expert axis, holding that row of every expert
  leaf of every layer back to back, pinned (``pin_memory``) when the
  weights live on the card.  A stage copies the decision's rows, and only
  them, into the weight rows: a few large copies a row (one a leaf), host
  to device over PCIe and asynchronous on the caller's stream.  The
  reference pads every stage to ``G x W`` rows so that one jit entry
  serves all of them; every staged value is a bit-identical copy of a
  device row, so the padding carries no information, and at full width a
  padded stage would move ``G * W`` rows of ~415 MB.  A stage copies a
  different number of rows each time, so it is never a graph.  Across
  processes each process's tier holds only the rows it hosts (JAX's
  per-rank residency cache over the rank's own shard): a stage's rows are
  global rank-major ids, and each process copies the ones it hosts, with
  no collective.
"""
from __future__ import annotations

import time
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import DistComm
from repro_torch.core.prefetch import join, stage_expert_rows
from repro_torch.serve.stepcore import Entry, Staged

EXPERT_LEAF_NAMES = ("w_in", "w_out", "w_gate")


def _moe_dicts(params: Any) -> List[dict]:
    """Every MoE parameter dict (one carrying a ``router`` and ``w_in``;
    dense MLPs reuse the ``w_in`` / ``w_out`` names without a router), in
    the deterministic order of the tree."""
    out: List[dict] = []

    def walk(tree):
        if isinstance(tree, dict):
            if "router" in tree and "w_in" in tree:
                out.append(tree)
                return
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    walk(params)
    return out


def expert_leaves(params: Any) -> List[torch.Tensor]:
    """Every expert weight leaf (``[..., rows, d, f]``, the row axis third
    from last), in the order ``_collect_expert_leaves`` of the JAX engine
    visits them."""
    return [p[n] for p in _moe_dicts(params) for n in EXPERT_LEAF_NAMES
            if n in p]


def replica_pairs(params: Any) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(source leaf, replica leaf) of every MoE layer's ``w_rep_*``."""
    return [(p[n], p["w_rep_" + n[2:]]) for p in _moe_dicts(params)
            for n in EXPERT_LEAF_NAMES if "w_rep_" + n[2:] in p]


class ReplicaSwap:
    """``swap(rows, ids)``: every replica leaf takes the hot experts' rows,
    in place (the JAX engine's ``_swap_replica_weights``).  In one process
    ``w_rep[..., i, :, :] = w[..., rows[i], :, :]``, ``rows`` [G * R] rows
    of the rank-major expert axis (the row axis is third from last in the
    stacked leaves).  Over a ``DistComm`` (``comm``, with the model's
    ``topo``) this rank's R slots fetch the experts of its row of ``ids``
    [G, R] (-1: an empty slot, left zero) from their hosts (module
    docstring)."""

    def __init__(self, params: Any, n_rows: int, device: torch.device,
                 comm: Any = None, topo: Any = None):
        self.pairs = replica_pairs(params)
        if not self.pairs:
            raise ValueError("replica swap: the parameters carry no w_rep_* "
                             "leaves")
        self.dist = comm if isinstance(comm, DistComm) else None
        self.topo = topo
        self._rows = Staged(n_rows, device)
        refuse = None
        if self.dist is not None and not self.dist.capturable:
            refuse = (f"the replica swap's communicator "
                      f"({self.dist.describe()}) cannot be captured")
        self.entry = Entry(self._gather, device, refuse)

    @property
    def captures(self) -> int:
        return self.entry.captures

    def _gather(self, pairs):
        if self.dist is None:
            rows = self._rows.dev
            for w, w_rep in pairs:
                torch.index_select(w, w.ndim - 3, rows, out=w_rep)
            return
        ids = self._rows.dev.view(self.topo.num_ranks, -1)
        for w, w_rep in pairs:
            got = self.dist.fetch_rows(w.movedim(-3, 0), ids, self.dist.rank,
                                       self.topo, count="swap_bytes")
            w_rep.movedim(-3, 0).copy_(join(got))

    def __call__(self, rows: np.ndarray, ids: np.ndarray) -> None:
        self._rows.fill()[:] = np.asarray(
            rows if self.dist is None else ids).reshape(-1)
        self._rows.push()
        self.entry(self.pairs)


class HostTier:
    """Every row of the expert leaves in host memory (module docstring),
    pinned when the leaves are on the card; raises if pinning fails.  The
    leaves hold the global rows ``[row0, row0 + n_rows)``: all of them in
    one process, a ``DistComm`` rank's own (``row0 = rank * epr``)."""

    def __init__(self, leaves: Sequence[torch.Tensor], row0: int = 0):
        self.leaves = list(leaves)
        self.row0 = row0
        w0 = self.leaves[0]
        self.n_rows = w0.shape[w0.ndim - 3]
        for w in self.leaves:
            if w.shape[w.ndim - 3] != self.n_rows:
                raise ValueError("expert leaves disagree on their row count")
        pin = w0.device.type == "cuda"
        # one row of each leaf: [..., d, f] with the row axis taken out
        shapes = [w.select(w.ndim - 3, 0).shape for w in self.leaves]
        sizes = [int(np.prod(s)) * w.element_size()
                 for s, w in zip(shapes, self.leaves)]
        self.row_bytes = sum(sizes)
        t0 = time.perf_counter()
        self._bufs = [torch.empty((self.row_bytes,), dtype=torch.uint8,
                                  pin_memory=pin) for _ in range(self.n_rows)]
        if pin and not all(b.is_pinned() for b in self._bufs):
            raise RuntimeError("host tier: pinning the expert rows failed")
        self.pin_s = time.perf_counter() - t0
        self.rows: List[List[torch.Tensor]] = []
        for buf in self._bufs:
            views, off = [], 0
            for w, s, n in zip(self.leaves, shapes, sizes):
                views.append(buf[off:off + n].view(w.dtype).view(s))
                off += n
            self.rows.append(views)
        t0 = time.perf_counter()
        for r, views in enumerate(self.rows):
            for w, v in zip(self.leaves, views):
                v.copy_(w.select(w.ndim - 3, r))
        self.fill_s = time.perf_counter() - t0

    @property
    def nbytes(self) -> int:
        return self.row_bytes * self.n_rows

    def own(self, rows: Sequence[int]) -> List[int]:
        """The local rows of those of the global ``rows`` this tier holds."""
        return [int(r) - self.row0 for r in rows
                if self.row0 <= int(r) < self.row0 + self.n_rows]

    def stage(self, rows: Sequence[int]) -> None:
        """Copy the global ``rows`` this tier holds into the leaves, one
        copy a row and leaf, on the current stream."""
        for r in self.own(rows):
            for w, v in zip(self.leaves, self.rows[r]):
                stage_expert_rows(w, [r], v.unsqueeze(w.ndim - 3))

    def release(self) -> None:
        """Drop the host buffers (the caller makes sure no copy from them
        is still in flight)."""
        self.rows, self._bufs = [], []
