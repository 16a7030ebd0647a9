"""Serving metrics (port of ``repro/serve/metrics.py``, with the JAX
report's schema).

Per request: TTFT = first_token_time - arrival_time (queueing + prefill),
TPOT = mean inter-token time over the decode phase, e2e = finish_time -
arrival_time.  Per step: active decode slots, paged KV-block occupancy,
the MoE block's scalar schedule diagnostics and its vector ones (per-rank
and per-expert loads), from which ``report()["load_balance"]`` is
derived, and each phase's tokens, wall seconds and analytic attention
KV bytes (``record_phase``, the ``phases`` section: prefill,
prefix_tail, decode and verify).  The ``residency`` section (hits,
misses, lookups, swaps, prefetches, stall_units, bytes_staged, hit_rate)
is the tiered-residency manager's counters, which the engine sets; it is
absent with residency off.  The prefix-sharing counters (``cow_copies``,
``evictions`` and ``resume_cached_tokens``, which the engine sets, and
``prefix_hit_rate``, the share of prompt tokens served from the cache at
first admission) and the ``speculative`` section (verify steps,
slot-steps, drafted, accepted and committed tokens, acceptance rate,
tokens per slot-step, slot-steps per committed token) are the JAX
report's.  ``report()`` is JSON-safe on an empty window (percentiles over
no requests come back as None).

A section that a report carries only sometimes attaches through one
rule, JAX's section convention: a section function returns the
section's dict, or a falsy value to leave it out (``section``); the
fleet router's ``fleet`` section attaches so.  ``aggregate_fleet`` pools
several engines' reports into the fleet's latency aggregates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.request import RequestState


# a report section's provider: () -> the section dict, or falsy to omit
SectionFn = Callable[[], Optional[Dict[str, Any]]]


def section(rep: Dict[str, Any], name: str, fn: SectionFn) -> None:
    """Attach ``fn()`` to ``rep`` under ``name`` iff it is not empty."""
    sec = fn()
    if sec:
        rep[name] = sec


def percentiles(xs, ps=(50, 90, 99)) -> Dict[str, float]:
    xs = np.asarray(list(xs), np.float64)
    if xs.size == 0:
        return {f"p{p}": float("nan") for p in ps} | {"mean": float("nan")}
    out = {f"p{p}": float(np.percentile(xs, p)) for p in ps}
    out["mean"] = float(xs.mean())
    return out


def _json_safe(x):
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x


@dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    n_generated: int
    arrival_time: float
    admitted_time: float
    first_token_time: float
    finish_time: float
    cached_prefix_tokens: int = 0   # prompt tokens served from the prefix
    #                                 cache at first admission

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> float:
        if self.n_generated <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) \
            / (self.n_generated - 1)

    @property
    def e2e(self) -> float:
        return self.finish_time - self.arrival_time

    def asdict(self) -> Dict[str, float]:
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "n_generated": self.n_generated,
                "arrival_time": self.arrival_time,
                "queue_delay": self.admitted_time - self.arrival_time,
                "ttft": self.ttft, "tpot": self.tpot, "e2e": self.e2e,
                "cached_prefix_tokens": self.cached_prefix_tokens}


class ServeMetrics:
    def __init__(self):
        self.requests: List[RequestRecord] = []
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.occupancy: List[int] = []          # active slots per decode step
        self.moe_diags: Dict[str, List[float]] = {}
        # per-step vector MoE diagnostics (rank_load [G], expert_load [Ep])
        self.load_vectors: Dict[str, List[np.ndarray]] = {}
        self.kv_blocks_in_use: List[int] = []
        self.kv_blocks_total = 0
        self.preemptions = 0
        # --- prefix sharing (paged) ---
        self.cow_copies = 0                     # copy-on-write block copies
        self.evictions = 0                      # cached prefixes evicted
        self.resume_cached_tokens = 0           # prefill skipped on resume
        # --- speculative decoding ---
        self.spec_steps = 0                     # verify steps run
        self.spec_slot_steps = 0                # active-slot verify passes
        self.spec_drafted = 0                   # draft tokens proposed
        self.spec_accepted = 0                  # draft tokens accepted
        self.spec_committed = 0                 # tokens committed by verify
        # per phase (prefill / prefix_tail / decode / verify): tokens, wall
        # seconds around the synced call, analytic attention KV bytes, calls
        self.phase_tokens: Dict[str, int] = {}
        self.phase_seconds: Dict[str, float] = {}
        self.phase_kv_bytes: Dict[str, int] = {}
        self.phase_steps: Dict[str, int] = {}
        # tiered expert residency's counters (serve/residency.py), set by
        # the engine's report(); None = residency off
        self.residency: Optional[Dict[str, Any]] = None

    @property
    def empty(self) -> bool:
        return not (self.requests or self.decode_steps or self.prefill_chunks)

    def record_step(self, diags: Dict[str, Any], n_active: int,
                    phase: str = "decode") -> None:
        """One prefill chunk or decode step; MoE diagnostics (host numbers
        or arrays) are kept per phase, scalars and vectors apart."""
        if phase == "decode":
            self.decode_steps += 1
            self.occupancy.append(n_active)
        else:
            self.prefill_chunks += 1
        for k, v in (diags or {}).items():
            arr = np.asarray(v)
            if arr.ndim:
                self.load_vectors.setdefault(f"{phase}/{k}", []).append(
                    arr.reshape(-1).astype(np.float64))
            else:
                self.moe_diags.setdefault(f"{phase}/{k}", []).append(
                    float(arr))

    def record_phase(self, phase: str, tokens: int, seconds: float,
                     kv_bytes: int) -> None:
        """One prefill chunk's or decode step's contribution to its
        phase: tokens processed, wall seconds around the synced call,
        analytic attention KV bytes."""
        self.phase_tokens[phase] = self.phase_tokens.get(phase, 0) \
            + int(tokens)
        self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) \
            + float(seconds)
        self.phase_kv_bytes[phase] = self.phase_kv_bytes.get(phase, 0) \
            + int(kv_bytes)
        self.phase_steps[phase] = self.phase_steps.get(phase, 0) + 1

    def record_kv(self, blocks_in_use: int, blocks_total: int) -> None:
        self.kv_blocks_in_use.append(int(blocks_in_use))
        self.kv_blocks_total = int(blocks_total)

    def complete(self, st: RequestState) -> RequestRecord:
        rec = RequestRecord(
            rid=st.req.rid, prompt_len=st.req.prompt_len,
            n_generated=st.n_generated, arrival_time=st.req.arrival_time,
            admitted_time=st.admitted_time,
            first_token_time=st.first_token_time,
            finish_time=st.finish_time,
            cached_prefix_tokens=st.cached_prefix_tokens or 0)
        self.requests.append(rec)
        return rec

    def report(self) -> Dict[str, Any]:
        recs = self.requests
        total_new = sum(r.n_generated for r in recs)
        total_prompt = sum(r.prompt_len for r in recs)
        span = (max(r.finish_time for r in recs)
                - min(r.arrival_time for r in recs)) if recs else 0.0
        rep: Dict[str, Any] = {
            "n_requests": len(recs),
            "total_new_tokens": total_new,
            "ttft": percentiles(r.ttft for r in recs),
            "tpot": percentiles(r.tpot for r in recs if r.n_generated > 1),
            "e2e": percentiles(r.e2e for r in recs),
            "queue_delay": percentiles(
                r.admitted_time - r.arrival_time for r in recs),
            "throughput_tok_s": total_new / span if span > 0 else float("nan"),
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "mean_occupancy": (float(np.mean(self.occupancy))
                               if self.occupancy else 0.0),
            "max_occupancy": (int(max(self.occupancy))
                              if self.occupancy else 0),
            "preemptions": self.preemptions,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "resume_cached_tokens": self.resume_cached_tokens,
            "prefix_hit_rate": (
                sum(r.cached_prefix_tokens for r in recs) / total_prompt
                if total_prompt else None),
            "requests": [r.asdict() for r in recs],
        }
        if self.kv_blocks_in_use:
            used = np.asarray(self.kv_blocks_in_use, np.float64)
            rep["kv_blocks_in_use"] = {"mean": float(used.mean()),
                                       "max": int(used.max())}
            rep["kv_utilization"] = (float(used.mean())
                                     / max(self.kv_blocks_total, 1))
        if self.moe_diags:
            rep["moe"] = {k: float(np.mean(v))
                          for k, v in self.moe_diags.items()}
        spec = self._speculative_section()
        if spec:
            rep["speculative"] = spec
        phases = self._phases_section()
        if phases:
            rep["phases"] = phases
        if self.residency:
            rep["residency"] = dict(self.residency)
        lb = self._load_balance()
        if lb:
            rep["load_balance"] = lb
        return _json_safe(rep)

    def _speculative_section(self) -> Optional[Dict[str, Any]]:
        """The JAX report's speculative section; per slot, so that plain
        decode reads one slot-step a committed token."""
        if not self.spec_steps:
            return None
        return {
            "steps": self.spec_steps,
            "slot_steps": self.spec_slot_steps,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "committed_tokens": self.spec_committed,
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else None),
            "tokens_per_step": (self.spec_committed / self.spec_slot_steps
                                if self.spec_slot_steps else None),
            "steps_per_committed_token": (
                self.spec_slot_steps / self.spec_committed
                if self.spec_committed else None),
        }

    def _phases_section(self) -> Optional[Dict[str, Any]]:
        if not self.phase_steps:
            return None
        out = {}
        for ph in sorted(self.phase_steps):
            tok, sec = self.phase_tokens.get(ph, 0), \
                self.phase_seconds.get(ph, 0.0)
            kvb = self.phase_kv_bytes.get(ph, 0)
            out[ph] = {"steps": self.phase_steps[ph], "tokens": tok,
                       "seconds": sec,
                       "tokens_per_s": tok / sec if sec > 0 else None,
                       "kv_bytes_touched": kvb,
                       "kv_bytes_per_token": kvb / tok if tok else None}
        return out

    def _load_balance(self) -> Dict[str, Any]:
        """Paper §5 load metrics per phase, from the per-step vector
        diagnostics: mean per-rank and per-expert load profiles, the
        max/mean rank-load ratio (1.0 = perfect balance), the straggler-wait
        proxy (mean of max - mean scheduled units per step: the units the
        average rank waits while the most loaded one finishes), and total
        drop counts."""
        out: Dict[str, Any] = {}
        for phase in ("decode", "prefill"):
            rl = self.load_vectors.get(f"{phase}/rank_load")
            el = self.load_vectors.get(f"{phase}/expert_load")
            if rl is None and el is None:
                continue
            sec: Dict[str, Any] = {}
            if rl:
                m = np.stack(rl)                      # [steps, G]
                mx, mn = m.max(axis=1), m.mean(axis=1)
                sec["rank_load_mean"] = m.mean(axis=0).tolist()
                sec["max_load_mean"] = float(mx.mean())
                sec["mean_load_mean"] = float(mn.mean())
                sec["max_mean_ratio"] = float(np.mean(
                    np.where(mn > 0, mx / np.maximum(mn, 1e-9), 1.0)))
                sec["straggler_wait_units"] = float(np.mean(mx - mn))
            if el:
                e = np.stack(el)                      # [steps, Ep]
                sec["expert_load_mean"] = e.mean(axis=0).tolist()
            for drop in ("send_drops", "dest_drops"):
                vals = self.moe_diags.get(f"{phase}/{drop}")
                if vals is not None:
                    sec[f"{drop}_total"] = float(np.sum(vals))
            out[phase] = sec
        return out


def aggregate_fleet(reports: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pool several engines' ``report()`` dicts into the fleet's latency
    aggregates, from the per-request rows each carries, whatever the
    engines' roles: in a disaggregated fleet the decode engines hold the
    completion records (a handoff carries the true arrival and first-token
    times across), so nothing is counted twice.  The replicas must share
    one clock: only then are their timestamps comparable."""
    rows = [r for rep in reports for r in rep.get("requests", ())]
    total_new = sum(r["n_generated"] for r in rows)
    finishes = [r["arrival_time"] + r["e2e"] for r in rows]
    span = (max(finishes) - min(r["arrival_time"] for r in rows)
            if rows else 0.0)
    prompt = sum(r["prompt_len"] for r in rows)
    agg: Dict[str, Any] = {
        "n_requests": len(rows),
        "total_new_tokens": total_new,
        "ttft": percentiles(r["ttft"] for r in rows),
        "tpot": percentiles(r["tpot"] for r in rows
                            if r["n_generated"] > 1),
        "e2e": percentiles(r["e2e"] for r in rows),
        "queue_delay": percentiles(r["queue_delay"] for r in rows),
        "throughput_tok_s": total_new / span if span > 0
        else float("nan"),
        # finished requests a second of fleet wall time
        "goodput_req_s": len(rows) / span if span > 0 else float("nan"),
        "preemptions": sum(rep.get("preemptions", 0) for rep in reports),
        "prefix_hit_rate": (
            sum(r["cached_prefix_tokens"] for r in rows) / prompt
            if prompt else None),
    }
    return _json_safe(agg)
