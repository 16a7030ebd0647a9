"""Between-window hot-expert replication (paper §4.2, Fig. 7).

Port of ``repro/serve/rebalance.py``: the host-side policy, numpy as in
the reference.  HarMoEny's scheduler (Alg. 2) rebalances token units
every step, but one scorching expert still bottlenecks its host rank: its
units cannot be split below the q-token granularity once every other rank
is saturated, and foreign-slot fetches pay the weight transfer every
step.  The answer is to replicate the hottest experts' weights on the
other ranks between serving windows, so the per-step scheduler treats
them as local destinations everywhere.

  * :class:`ExpertRebalancer` folds the per-step ``expert_load``
    diagnostic ([Ep] global token units per expert) into an EMA and,
    every ``rebalance_interval`` steps, proposes a replica-slot
    assignment: the top-R experts whose EMA load exceeds ``hot_threshold
    x mean`` get their weights copied into the R replica slots of every
    rank but their host.

  * :class:`RebalanceDecision` carries the new ``replica_ids`` [G, R]
    (which the engine's captured steps read from a static device buffer:
    a swap changes values, never a graph) and ``weight_rows`` [G*R],
    rows of the rank-major stacked expert axis that the engine's captured
    swap gathers into the ``w_rep_*`` leaves in place.

Shapes are static: the R slots exist from init (zero weights, ids all
-1), and a decision only changes values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.topology import EPTopology, local_slot_of


@dataclasses.dataclass(frozen=True)
class RebalanceDecision:
    """One proposed replica assignment (see module docstring)."""
    replica_ids: np.ndarray    # [G, R] int32, -1 = slot empty
    weight_rows: np.ndarray    # [G*R] int32 rows into the stacked expert axis
    hot_experts: List[int]     # replicated experts, hottest first
    changed: bool              # False => identical to the previous decision


class ExpertRebalancer:
    """EMA load tracker + greedy hot-expert replica placement.

    Parameters
    ----------
    topo:
        The serving model's expert-parallel topology (decode and prefill
        share it; replica ids are expressed in global expert ids).
    num_replica_slots:
        R, the static per-rank replica slot count (= MoEConfig value).
    ema_alpha:
        Weight of the newest step in the exponential moving average.
    hot_threshold:
        An expert is "hot" when ema[e] > hot_threshold * mean(ema). The
        paper uses mean-relative thresholds so uniform streams never
        trigger swaps regardless of absolute throughput.
    """

    def __init__(self, topo: EPTopology, num_replica_slots: int, *,
                 ema_alpha: float = 0.2, hot_threshold: float = 1.5):
        if num_replica_slots <= 0:
            raise ValueError("num_replica_slots must be > 0")
        if topo.hosts_per_expert != 1:
            raise ValueError(
                "hot-expert replication requires E >= num_ranks "
                "(each expert having a unique host)")
        self.topo = topo
        self.R = int(num_replica_slots)
        self.ema_alpha = float(ema_alpha)
        self.hot_threshold = float(hot_threshold)
        self.ema: Optional[np.ndarray] = None        # [Ep] float64
        # optional per-layer EMAs (observe(layer=...)): distinct MoE
        # layers can run disjoint hot sets, and a global EMA blurs them —
        # the residency manager's prefetch predictor reads these, while
        # hot()/propose() keep reading the global EMA (replica slots are
        # shared across layers, so placement stays layer-agnostic)
        self.layer_ema: Dict[int, np.ndarray] = {}
        self.steps_observed = 0
        self._lsl = local_slot_of(topo)              # [G, Ep]
        self._last_ids = np.full(
            (topo.num_ranks, self.R), -1, np.int32)  # init state: all empty

    # ---------------------------------------------------------------- observe
    def observe(self, expert_load: np.ndarray,
                layer: Optional[int] = None) -> None:
        """Fold one step's [Ep] global expert-load vector into the EMA.

        With ``layer`` the load is *additionally* folded into that
        layer's own EMA (``layer_ema[layer]``, created on first use) —
        the global EMA updates identically either way, so callers that
        never pass ``layer`` see exactly the historical behavior."""
        v = np.asarray(expert_load, np.float64).reshape(-1)
        if v.shape[0] != self.topo.padded_experts:
            raise ValueError(
                f"expert_load has {v.shape[0]} entries, topology expects "
                f"{self.topo.padded_experts}")
        if self.ema is None:
            self.ema = v.copy()
        else:
            self.ema = (1.0 - self.ema_alpha) * self.ema + self.ema_alpha * v
        if layer is not None:
            prev = self.layer_ema.get(int(layer))
            self.layer_ema[int(layer)] = v.copy() if prev is None \
                else (1.0 - self.ema_alpha) * prev + self.ema_alpha * v
        self.steps_observed += 1

    # ---------------------------------------------------------------- propose
    def hot(self) -> List[int]:
        """Top-R hot experts by EMA (hottest first); [] before any observe.

        Padding experts (E <= e < Ep) are routed no tokens and therefore
        can never exceed the mean-relative threshold.
        """
        if self.ema is None:
            return []
        mean = float(self.ema.mean())
        if mean <= 0.0:
            return []
        order = np.argsort(-self.ema, kind="stable")
        out: List[int] = []
        for e in order[: self.R]:
            if self.ema[e] > self.hot_threshold * mean:
                out.append(int(e))
        return out

    def propose(self) -> RebalanceDecision:
        """Greedy placement: hot expert r -> replica slot r of every rank
        except its host (the host already serves it from a local slot).

        Empty slots keep id -1 and point their weight row at row 0 — the
        gathered weights are dead (never scheduled to) but the gather must
        stay in-bounds with static shapes.
        """
        topo = self.topo
        G, epr = topo.num_ranks, topo.experts_per_rank
        hot = self.hot()
        ids = np.full((G, self.R), -1, np.int32)
        rows = np.zeros((G * self.R,), np.int32)
        for r, e in enumerate(hot):
            host = int(topo.host_of[e, 0])
            src_row = host * epr + int(self._lsl[host, e])
            for g in range(G):
                if g == host:
                    continue                      # local slot already serves e
                ids[g, r] = e
                rows[g * self.R + r] = src_row
        changed = not np.array_equal(ids, self._last_ids)
        if changed:
            self._last_ids = ids.copy()
        return RebalanceDecision(replica_ids=ids, weight_rows=rows,
                                 hot_experts=hot, changed=changed)
