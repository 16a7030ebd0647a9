"""Fleet serving: a router over N ``ServeEngine`` replicas (port of
``repro/serve/fleet.py``).

``FleetRouter`` owns one global arrival queue and a set of engine
replicas: a deployment gives each replica devices of its own, and the
tests and ``chip_smoke.py`` run *virtual* replicas (several engines on one
model and one card, each with its own pool).  It drives them in lockstep
off **one shared clock**: each ``tick()`` reads the clock once, routes
every request that has arrived to a replica, then steps every replica at
that one timestamp (``ServeEngine.step(now, wait_when_idle=False)``).
With one replica this is the bare engine's loop, with the same clock
calls, admissions and idle waits, so its token streams and timestamps
equal the engine's.

Routing policies (``ROUTING_POLICIES``):

* ``load``: the replica with the least committed work, queued prefill
  tokens (``AdmissionFront.queued_tokens``) plus KV tokens in use.  Ties
  go to the lowest replica index.
* ``prefix_affinity``: the load score minus ``affinity_weight`` times the
  longest cached prefix the replica holds for the request
  (``ServeEngine.probe_prefix``, a pure lookup that leaves a replica's LRU
  order as it is), so requests that share a system prompt go where it is
  cached.
* ``round_robin``: arrival order modulo the replica count (the baseline).

An ``assignment`` dict (rid -> replica index) overrides the policy a
request: replaying one policy's decisions under another shows that
routing only places work and changes nothing a replica computes.

**Disaggregated**: ``prefill``-role and ``decode``-role engines.
Arrivals go to the prefill replicas; each finished prefill comes out as
a ``HandoffRecord`` (``pop_handoffs``), and the router moves it to the
least-loaded decode replica (``import_handoff``; False means no slot or
blocks free now: the record waits in FIFO order and is tried again every
tick).  Decode replicas never see a prompt, so a burst of long prompts
cannot stall the decodes in flight.

There is no fleet of engines over ``DistComm``: those run in lockstep
across processes on rank 0's clock, which the JAX package's fleet has no
counterpart of, and ``FleetRouter`` refuses them: a deliberate
difference from the JAX package, which has no lockstep fleet.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.serve.arrivals import AdmissionQueue
from repro_torch.serve.kvstore import HandoffRecord
from repro_torch.serve.metrics import aggregate_fleet
from repro_torch.serve.metrics import section as metrics_section
from repro_torch.serve.request import Request

ROUTING_POLICIES = ("load", "prefix_affinity", "round_robin")


class FleetRouter:
    def __init__(self, engines: Sequence[Any], *, policy: str = "load",
                 affinity_weight: float = 1.0,
                 assignment: Optional[Dict[int, int]] = None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; choose "
                             f"one of {ROUTING_POLICIES}")
        if affinity_weight < 0:
            raise ValueError("affinity_weight must be >= 0")
        if any(getattr(e, "dist", None) is not None for e in engines):
            raise NotImplementedError(
                "FleetRouter over engines across processes (DistComm): "
                "they step in lockstep on rank 0's clock, and the JAX "
                "package has no lockstep fleet to mirror (a deliberate "
                "difference: one engine a process, no router)")
        self.engines = list(engines)
        self.clock = self.engines[0].clock
        for i, e in enumerate(self.engines):
            if e.clock is not self.clock:
                raise ValueError(
                    f"replica {i} has its own clock; fleet timestamps are "
                    f"only comparable when every engine shares one clock "
                    f"object")
        # arrivals go to engines that can prefill; handoffs to decode-role
        self._serve_idx = [i for i, e in enumerate(self.engines)
                           if e.role in ("unified", "prefill")]
        self._decode_idx = [i for i, e in enumerate(self.engines)
                            if e.role == "decode"]
        self._prefill_idx = [i for i, e in enumerate(self.engines)
                             if e.role == "prefill"]
        if not self._serve_idx:
            raise ValueError("fleet has no unified/prefill engine to "
                             "take arrivals")
        if self._prefill_idx and not self._decode_idx:
            raise ValueError("fleet has prefill-role engines but no "
                             "decode-role engine to hand off to")
        self.disaggregated = bool(self._prefill_idx)
        self.policy = policy
        self.affinity_weight = affinity_weight
        self.assignment = dict(assignment or {})

        self.queue = AdmissionQueue()
        self._pending: deque = deque()   # handoffs awaiting a free slot
        self._rr = 0                     # round-robin cursor
        self._decisions: List[Dict[str, Any]] = []
        self._routed_counts = [0] * len(self.engines)
        self._affinity_hits = 0          # routed where the match was > 0
        self._affinity_hit_tokens = 0
        self._handoffs_moved = 0
        self._handoff_bytes = 0
        self._ticks = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.push(req)

    def has_work(self) -> bool:
        return bool(len(self.queue) or self._pending
                    or any(e.has_work() for e in self.engines))

    def warmup(self) -> None:
        for e in self.engines:
            e.warmup()

    # ------------------------------------------------------------------
    def _load_score(self, idx: int) -> float:
        stats = self.engines[idx].load_stats()
        return float(stats["queued_tokens"] + stats["kv_tokens"])

    def _route(self, req: Request) -> int:
        """Pick the replica for one arrival and record the decision."""
        matched = 0
        if req.rid in self.assignment:
            idx = self.assignment[req.rid]
            how = "assignment"
        elif self.policy == "round_robin":
            idx = self._serve_idx[self._rr % len(self._serve_idx)]
            self._rr += 1
            how = "round_robin"
        else:
            best = None
            for i in self._serve_idx:
                score = self._load_score(i)
                match = 0
                if self.policy == "prefix_affinity":
                    match = self.engines[i].probe_prefix(req.tokens)
                    score -= self.affinity_weight * match
                # strict < : ties go to the lowest replica index
                if best is None or score < best[0]:
                    best = (score, i, match)
            _, idx, matched = best
            how = self.policy
            if matched > 0:
                self._affinity_hits += 1
                self._affinity_hit_tokens += matched
        self._decisions.append({"rid": req.rid, "replica": idx,
                                "policy": how,
                                "matched_tokens": int(matched)})
        self._routed_counts[idx] += 1
        return idx

    def _move_handoffs(self) -> bool:
        """Collect every prefill replica's exported records and import each
        into the least-loaded decode replica; records that fit nowhere now
        stay queued in FIFO order."""
        for i in self._prefill_idx:
            self._pending.extend(self.engines[i].pop_handoffs())
        moved = False
        still: deque = deque()
        while self._pending:
            rec: HandoffRecord = self._pending.popleft()
            order = sorted(self._decode_idx, key=lambda i:
                           (self._load_score(i), i))
            for i in order:
                if self.engines[i].import_handoff(rec):
                    self._handoffs_moved += 1
                    self._handoff_bytes += rec.nbytes
                    moved = True
                    break
            else:
                still.append(rec)
        self._pending = still
        return moved

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One fleet tick: route the arrivals, step every replica at one
        shared timestamp, move the handoffs, then, if nothing ran anywhere,
        wait toward the earliest next arrival."""
        now = self.clock.now()
        while True:
            req = self.queue.pop_ready(now)
            if req is None:
                break
            self.engines[self._route(req)].submit(req)
        did = False
        for e in self.engines:
            did = e.step(now, wait_when_idle=False) or did
        if self.disaggregated:
            did = self._move_handoffs() or did
        self._ticks += 1
        if not did:
            heads = [self.queue.next_arrival()] \
                + [e.queue.next_arrival() for e in self.engines]
            heads = [h for h in heads if h is not None]
            if heads:
                self.clock.wait(min(max(min(heads) - now, 0.0), 0.01))
        return did

    def run(self, requests: Sequence[Request] = (), *,
            max_ticks: int = 1_000_000) -> Dict[str, Any]:
        """Drive the fleet until all work drains (``ServeEngine.run``'s
        loop, with its fresh-window clock rebase)."""
        if not self._pending \
                and all(not e._in_flight() and e.metrics.empty
                        for e in self.engines):
            self.clock.reset()
        for r in requests:
            self.submit(r)
        ticks = 0
        while self.has_work():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"fleet exceeded {max_ticks} ticks with "
                                   f"work remaining")
        return self.report()

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Each replica's own report (``replica_reports``) and the
        ``fleet`` section: per replica, the aggregate, routing and the
        handoffs."""
        reps = [e.report() for e in self.engines]
        routed = len(self._decisions)

        def fleet_section() -> Dict[str, Any]:
            return {
                "n_replicas": len(self.engines),
                "disaggregated": self.disaggregated,
                "ticks": self._ticks,
                "replicas": [
                    {"index": i, "role": e.role,
                     "n_requests": rep["n_requests"],
                     "ttft": rep["ttft"], "tpot": rep["tpot"],
                     "e2e": rep["e2e"],
                     "throughput_tok_s": rep["throughput_tok_s"],
                     "steps": rep["engine"]["steps"],
                     "routed": self._routed_counts[i],
                     "handoffs": rep["engine"].get("handoffs")}
                    for i, (e, rep) in enumerate(zip(self.engines, reps))],
                "aggregate": aggregate_fleet(reps),
                "routing": {
                    "policy": self.policy,
                    "affinity_weight": self.affinity_weight,
                    "routed": routed,
                    "per_replica": list(self._routed_counts),
                    "affinity_hits": self._affinity_hits,
                    "affinity_hit_rate": (self._affinity_hits / routed
                                          if routed else None),
                    "affinity_hit_tokens": self._affinity_hit_tokens,
                    "decisions": list(self._decisions),
                },
                "handoffs": {
                    "moved": self._handoffs_moved,
                    "bytes": self._handoff_bytes,
                    "pending": len(self._pending),
                },
            }

        out: Dict[str, Any] = {"replica_reports": reps}
        metrics_section(out, "fleet", fleet_section)
        return out
