"""Tiered expert residency with asynchronous prefetch (paper §4.3).

Port of ``repro/serve/residency.py``: the host-side half, numpy as in the
reference.  HarMoEny's contribution (ii): when expert weights exceed
device memory, keep a bounded working set of each rank's experts resident
and stream the rest in from a slower tier (host memory over PCIe) ahead of
use, predicted from the previous layer's router decisions.

Where the reference emulates the host tier (a numpy copy staged by a
jitted scatter), the port's serve engine holds it in pinned host memory
and copies each stage's rows to the card over the real link
(``ServeEngine``).  As in the reference, the device parameters stay
authoritative: every staged value is a bit-identical copy of a device
row, so greedy streams are token-identical across budgets, while the
``[G, W]`` table rides into the captured decode step in a static device
buffer and demotes non-resident experts to fetch-paying work in the
harmoeny schedule (``non_local``).

Three pieces:

  * :class:`ResidencyCache` — a per-rank pinned-LRU cache over the rank's
    own expert shard: budget never exceeded, pinned experts never
    evicted, ``hits + misses == lookups``, evictions in LRU order.

  * :class:`ExpertResidencyManager` — folds the per-layer
    ``expert_load`` diagnostic into a per-layer EMA, replays each engine
    step layer by layer against the caches and emits a
    :class:`ResidencyDecision`: the next ``[G, W]`` table, the stacked
    weight rows to stage, and the step's hit/stall/bytes accounting.
    ``predictive`` prefetches, during layer l's compute window, the
    experts the EMA predicts layer l+1 will route to (a predicted miss
    costs bytes but no stall); ``on_demand`` stages on first touch and
    stalls every time; ``none`` freezes the initial working set.

  * :class:`TierCostModel` — expert bytes over a modeled PCIe rate.  Its
    default stays the reference's 16e9 B/s, so ``stall_units`` equals
    the reference's; the rate the card's link reaches is measured beside
    it (``chip_smoke.py``), never put in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.topology import EPTopology, local_slot_of

PREFETCH_POLICIES = ("predictive", "on_demand", "none")


@dataclasses.dataclass(frozen=True)
class TierCostModel:
    """Modeled host-to-device staging cost (PCIe gen4 x16 by default)."""
    expert_bytes: float = 0.0      # bytes per expert's weight rows (per rank)
    pcie_bw: float = 16e9          # host→device link, bytes/s

    def stall_units(self, n_experts: int) -> float:
        """Seconds of serialized transfer for ``n_experts`` demand misses."""
        if self.expert_bytes <= 0.0:
            return float(n_experts)          # unit-cost fallback (tests)
        return n_experts * self.expert_bytes / self.pcie_bw


class ResidencyCache:
    """Pinned-LRU working set over one rank's expert shard.

    Pure counter/ordering bookkeeping — the fuzz target for
    ``tests/test_residency_properties.py``. ``capacity`` is the HBM
    budget W (slots); ``experts`` the ids eligible to be cached (the
    rank's own static shard). Pinning marks the experts the *current*
    layer is routing to: they may not be evicted mid-step, so a stage
    that would require evicting a pinned expert fails (returns None)
    rather than corrupting in-flight compute.
    """

    def __init__(self, capacity: int, experts: Sequence[int]):
        if capacity <= 0:
            raise ValueError("residency capacity must be > 0")
        self.capacity = int(capacity)
        self.eligible = frozenset(int(e) for e in experts)
        if self.capacity > len(self.eligible):
            raise ValueError(
                f"capacity {capacity} exceeds shard size {len(self.eligible)}")
        self._lru: List[int] = []         # least-recent first
        self._pinned: set = set()
        self.hits = 0
        self.misses = 0
        self.lookups = 0
        self.evictions = 0
        self.stages = 0

    # ------------------------------------------------------------- state
    @property
    def resident(self) -> List[int]:
        """Resident experts, least-recently-used first."""
        return list(self._lru)

    def __contains__(self, e: int) -> bool:
        return int(e) in set(self._lru)

    def __len__(self) -> int:
        return len(self._lru)

    # ---------------------------------------------------------------- ops
    def lookup(self, e: int) -> bool:
        """Count a use of expert ``e``; True = hit (refreshes recency)."""
        e = int(e)
        if e not in self.eligible:
            raise KeyError(f"expert {e} is not in this rank's shard")
        self.lookups += 1
        if e in self._lru:
            self.hits += 1
            self._lru.remove(e)
            self._lru.append(e)           # most-recent position
            return True
        self.misses += 1
        return False

    def stage(self, e: int) -> Optional[int]:
        """Make ``e`` resident, evicting the LRU unpinned expert if full.

        Returns the evicted expert id, -1 if a free slot absorbed the
        stage, or None if the stage is impossible (every slot pinned) —
        the caller must not treat ``e`` as resident in that case.
        Staging an already-resident expert is a no-op refresh.
        """
        e = int(e)
        if e not in self.eligible:
            raise KeyError(f"expert {e} is not in this rank's shard")
        if e in self._lru:
            self._lru.remove(e)
            self._lru.append(e)
            return -1
        evicted = -1
        if len(self._lru) >= self.capacity:
            victim = next((v for v in self._lru if v not in self._pinned),
                          None)
            if victim is None:
                return None               # all pinned: cannot make room
            self._lru.remove(victim)
            self.evictions += 1
            evicted = victim
        self._lru.append(e)
        self.stages += 1
        return evicted

    def evict(self, e: int) -> bool:
        """Explicitly drop ``e``; False if pinned or not resident."""
        e = int(e)
        if e in self._pinned or e not in self._lru:
            return False
        self._lru.remove(e)
        self.evictions += 1
        return True

    def pin(self, experts: Sequence[int]) -> None:
        """Pin the current layer's working experts against eviction."""
        self._pinned = {int(e) for e in experts} & self.eligible

    def unpin(self) -> None:
        self._pinned = set()

    @property
    def pinned(self) -> frozenset:
        return frozenset(self._pinned)


@dataclasses.dataclass(frozen=True)
class ResidencyDecision:
    """One step's residency update: the engine applies step t's decision
    at the start of step t+1, copying its rows from the host tier before
    that step's decode reads them."""
    residency_ids: np.ndarray   # [G, W] int32 resident expert ids per rank
    stage_rows: np.ndarray      # [n_staged] int32 stacked weight-row indices
    changed: bool               # False => table identical to the previous one
    hits: int
    misses: int
    prefetches: int             # predictive stages ahead of first touch
    stall_units: float          # modeled serialized-transfer seconds
    bytes_staged: float


class ExpertResidencyManager:
    """Per-rank tiered residency driven by per-layer router load.

    Parameters
    ----------
    topo:
        Serving expert-parallel topology. Requires ``hosts_per_expert == 1``
        (same constraint as replication: each expert has one host rank).
    resident_experts:
        Pod-total HBM working-set budget; must divide evenly into
        ``W = resident_experts / G`` slots per rank, ``1 <= W <= epr``.
        ``resident_experts == padded_experts`` means everything fits
        (fully resident — the differential-test baseline).
    policy:
        ``predictive`` | ``on_demand`` | ``none`` (see module docstring).
    cost:
        Tier cost model; the engine fills ``expert_bytes`` from the real
        parameter leaves.
    ema_alpha:
        Per-layer EMA smoothing weight (same default as ``ExpertRebalancer``).
    """

    def __init__(self, topo: EPTopology, resident_experts: int, *,
                 policy: str = "predictive",
                 cost: Optional[TierCostModel] = None,
                 ema_alpha: float = 0.2):
        if policy not in PREFETCH_POLICIES:
            raise ValueError(
                f"prefetch_policy must be one of {PREFETCH_POLICIES}, "
                f"got {policy!r}")
        if topo.hosts_per_expert != 1:
            raise ValueError(
                "tiered expert residency requires E >= num_ranks "
                "(each expert having a unique host)")
        G, epr = topo.num_ranks, topo.experts_per_rank
        if resident_experts <= 0 or resident_experts % G != 0:
            raise ValueError(
                f"resident_experts={resident_experts} must be a positive "
                f"multiple of the EP degree {G}")
        W = resident_experts // G
        if W > epr:
            raise ValueError(
                f"resident_experts={resident_experts} exceeds the pod's "
                f"{G * epr} expert rows ({W} slots/rank > {epr}/rank)")
        self.topo = topo
        self.W = W
        self.policy = policy
        self.cost = cost if cost is not None else TierCostModel()
        self.ema_alpha = float(ema_alpha)
        self._lsl = local_slot_of(topo)                      # [G, Ep]
        # per-layer EMA of the [Ep] expert-load diagnostic
        self.layer_ema: Dict[int, np.ndarray] = {}
        self.steps_observed = 0
        # one pinned-LRU cache per rank over its own shard; seed the
        # working set with the first W local slots so step 0 is defined
        self.caches = [ResidencyCache(W, topo.slot_map[g])
                       for g in range(G)]
        for g in range(G):
            for j in range(W):
                self.caches[g].stage(int(topo.slot_map[g, j]))
        self._last_ids = self._table()
        # lifetime counters (metrics window reads + resets via counters())
        self._win = dict(hits=0, misses=0, lookups=0, swaps=0,
                         prefetches=0, stall_units=0.0, bytes_staged=0.0)

    # ------------------------------------------------------------- helpers
    @property
    def fully_resident(self) -> bool:
        return self.W == self.topo.experts_per_rank

    def _table(self) -> np.ndarray:
        """[G, W] residency table: resident expert ids, -1 pads.

        Sorted per rank: the device side only tests membership, so a
        recency-order permutation must not read as a table change (the
        ``none`` policy's table stays literally frozen)."""
        G = self.topo.num_ranks
        ids = np.full((G, self.W), -1, np.int32)
        for g in range(G):
            res = sorted(self.caches[g].resident)
            ids[g, :len(res)] = res
        return ids

    def _row(self, g: int, e: int) -> int:
        return g * self.topo.experts_per_rank + int(self._lsl[g, e])

    def observe(self, layer_loads: np.ndarray) -> None:
        """Fold one step's [L, Ep] per-layer expert loads into the EMAs."""
        loads = np.asarray(layer_loads, np.float64)
        if loads.ndim != 2 or loads.shape[1] != self.topo.padded_experts:
            raise ValueError(
                f"layer_loads must be [n_moe_layers, {self.topo.padded_experts}]"
                f", got {loads.shape}")
        a = self.ema_alpha
        for layer in range(loads.shape[0]):
            prev = self.layer_ema.get(layer)
            self.layer_ema[layer] = loads[layer].copy() if prev is None \
                else (1.0 - a) * prev + a * loads[layer]
        self.steps_observed += 1

    def _predict(self, layer: int, g: int) -> List[int]:
        """Top-W local experts the EMA expects layer ``layer`` to use."""
        ema = self.layer_ema.get(layer)
        if ema is None:
            return []
        local = self.topo.slot_map[g]
        order = np.argsort(-ema[local], kind="stable")
        return [int(local[j]) for j in order if ema[local[j]] > 0.0][: self.W]

    # ---------------------------------------------------------------- step
    def step(self, layer_loads: np.ndarray) -> ResidencyDecision:
        """Replay one engine step's per-layer loads through the caches.

        Folds the loads into the per-layer EMA, then walks the layers in
        execution order: experts the router sent tokens to are looked up
        (pinning them for the layer), demand misses are staged (stalling
        under ``on_demand``/unpredicted ``predictive``; never staged
        under ``none``), and — under ``predictive`` — the *next* layer's
        EMA-top experts are prefetched during this layer's compute
        window, hiding their transfer behind the modeled overlap.
        """
        loads = np.asarray(layer_loads, np.float64)
        self.observe(loads)
        G = self.topo.num_ranks
        n_layers = loads.shape[0]
        hits = misses = prefetches = 0
        stall = bytes_staged = 0.0
        stage_rows: List[int] = []
        prefetched: List[set] = [set() for _ in range(G)]
        for layer in range(n_layers):
            for g in range(G):
                cache = self.caches[g]
                local = self.topo.slot_map[g]
                used = [int(e) for e in local if loads[layer, e] > 0.0]
                cache.pin(used)
                for e in used:
                    if cache.lookup(e):
                        hits += 1
                        continue
                    misses += 1
                    if self.policy == "none":
                        # frozen working set: pay the tier cost every use
                        stall += self.cost.stall_units(1)
                        continue
                    if cache.stage(e) is None:
                        stall += self.cost.stall_units(1)
                        continue          # all slots pinned: serve from host
                    bytes_staged += self.cost.expert_bytes
                    self._win["swaps"] += 1
                    stage_rows.append(self._row(g, e))
                    if e in prefetched[g]:
                        prefetched[g].discard(e)   # double-counted stage
                    else:
                        stall += self.cost.stall_units(1)
                # predictive: stage next layer's predicted experts now —
                # the transfer overlaps this layer's compute, so a correct
                # prediction turns a stall into hidden bytes
                if self.policy == "predictive" and layer + 1 < n_layers:
                    for e in self._predict(layer + 1, g):
                        if e in cache:
                            continue
                        if cache.stage(e) is None:
                            continue      # pinned-full: skip the prefetch
                        prefetches += 1
                        bytes_staged += self.cost.expert_bytes
                        self._win["swaps"] += 1
                        stage_rows.append(self._row(g, e))
                        prefetched[g].add(e)
                cache.unpin()
        ids = self._table()
        changed = not np.array_equal(ids, self._last_ids)
        self._last_ids = ids.copy()
        self._win["hits"] += hits
        self._win["misses"] += misses
        self._win["lookups"] += hits + misses
        self._win["prefetches"] += prefetches
        self._win["stall_units"] += stall
        self._win["bytes_staged"] += bytes_staged
        return ResidencyDecision(
            residency_ids=ids,
            stage_rows=np.asarray(sorted(set(stage_rows)), np.int32),
            changed=changed, hits=hits, misses=misses,
            prefetches=prefetches, stall_units=stall,
            bytes_staged=bytes_staged)

    # ------------------------------------------------------------- metrics
    def counters(self) -> Dict[str, float]:
        """Lifetime residency counters for ``report()["residency"]``."""
        w = dict(self._win)
        w["hit_rate"] = (w["hits"] / w["lookups"]) if w["lookups"] else None
        return w
