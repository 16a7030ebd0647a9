"""Arrival processes, clocks and the admission queue (port of
``repro/serve/arrivals.py``; numpy for numpy, so the same seed gives the
reference's requests exactly).

Request sources: ``poisson_requests`` (open-loop Poisson arrivals at
``rate`` req/s with synthetic prompts; rate 0 is a closed batch at t=0),
``long_context_requests``, ``bursty_requests``, and ``trace_requests`` /
``load_trace`` (explicit records, e.g. a JSON file from a serving log).

The engine reads time from a clock: ``WallClock`` for real serving,
``VirtualClock`` for deterministic tests (each ``now()`` advances a fixed
dt, so arrival draining always terminates).
"""
from __future__ import annotations

import heapq
import json
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.request import Request


class WallClock:
    """Monotonic wall time, zeroed at construction and by ``reset()``."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait(self, dt: float) -> None:
        time.sleep(max(dt, 0.0))


class VirtualClock:
    """Deterministic clock: every ``now()`` advances by ``dt``."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = dt
        self.t0 = t0
        self.t = t0

    def reset(self) -> None:
        self.t = self.t0

    def now(self) -> float:
        self.t += self.dt
        return self.t

    def wait(self, dt: float) -> None:
        self.t += max(dt, 0.0)


# ----------------------------------------------------------------------
# Request generators
# ----------------------------------------------------------------------
def poisson_requests(n: int, *, rate: float, vocab_size: int,
                     prompt_len: int, max_new_tokens: int,
                     seed: int = 0, rid_base: int = 0,
                     prompt_len_range: Optional[Tuple[int, int]] = None,
                     shared_prefix_len: int = 0,
                     eos_id: Optional[int] = None) -> List[Request]:
    """n synthetic requests with exponential inter-arrival times.

    rate <= 0 means a closed batch: all requests arrive at t=0.
    ``prompt_len_range=(lo, hi)`` draws per-request prompt lengths
    uniformly; otherwise every prompt has ``prompt_len`` tokens.
    ``shared_prefix_len=k`` makes the first ``min(k, prompt_len)`` tokens
    of every prompt identical (one draw shared across the batch) — the
    system-prompt/few-shot-template regime prefix caching targets.
    ``rid_base`` offsets the assigned rids so several sub-streams (one
    per replica / prefix group, seeded via ``split_seeds``) can be merged
    without rid collisions.
    """
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size,
                          (max(shared_prefix_len, 0),)).astype(np.int32)
    t = 0.0
    out: List[Request] = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        if prompt_len_range is not None:
            lo, hi = prompt_len_range
            plen = int(rng.integers(lo, hi + 1))
        else:
            plen = prompt_len
        toks = rng.integers(0, vocab_size, (plen,)).astype(np.int32)
        k = min(len(prefix), plen)
        if k:
            toks[:k] = prefix[:k]
        out.append(Request(rid=rid_base + i, tokens=toks,
                           max_new_tokens=max_new_tokens,
                           arrival_time=t, eos_id=eos_id))
    return out


def long_context_requests(n: int, *, vocab_size: int, max_seq_len: int,
                          max_new_tokens: int, rate: float = 0.0,
                          long_frac: float = 0.5, short_len: int = 32,
                          seed: int = 0, rid_base: int = 0,
                          eos_id: Optional[int] = None) -> List[Request]:
    """A long-context mix: ``long_frac`` of the requests carry prompts
    drawn near the pool ceiling (uniform in ``[max_seq_len // 2,
    max_seq_len - max_new_tokens]``), the rest are short (``short_len``)
    interactive prompts.  Long prompts dominate state-pool residency while
    the short ones queue behind them — the regime that exercises
    sliding-window clamping (prompts far beyond the window) and state-pool
    admission pressure.  Prompt lengths are intentionally *not* rounded to
    chunk or block multiples, so partial final chunks are always present.
    """
    if not 0.0 <= long_frac <= 1.0:
        raise ValueError("long_frac must be in [0, 1]")
    rng = np.random.default_rng(seed)
    hi = max(max_seq_len - max_new_tokens, 1)
    lo = max(min(max_seq_len // 2, hi - 1), 1)
    t = 0.0
    out: List[Request] = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        if rng.random() < long_frac:
            plen = int(rng.integers(lo, hi + 1))
        else:
            plen = max(min(short_len, hi), 1)
        toks = rng.integers(0, vocab_size, (plen,)).astype(np.int32)
        out.append(Request(rid=rid_base + i, tokens=toks,
                           max_new_tokens=max_new_tokens,
                           arrival_time=t, eos_id=eos_id))
    return out


def bursty_requests(n: int, *, vocab_size: int, prompt_len: int,
                    max_new_tokens: int, burst_size: int = 4,
                    burst_gap: float = 1.0, seed: int = 0,
                    rid_base: int = 0,
                    prompt_len_range: Optional[Tuple[int, int]] = None,
                    eos_id: Optional[int] = None) -> List[Request]:
    """Bursty arrivals: requests land in bursts of ``burst_size`` that
    arrive simultaneously, with ``burst_gap`` seconds of silence between
    bursts.  Each burst oversubscribes slots/blocks at one instant — the
    preemption + re-admission regime a smooth Poisson stream at the same
    mean rate rarely triggers — while the gaps let the engine drain, so
    queueing does not grow without bound over the trace."""
    if burst_size < 1:
        raise ValueError("burst_size must be >= 1")
    if burst_gap < 0:
        raise ValueError("burst_gap must be >= 0")
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for i in range(n):
        t = (i // burst_size) * burst_gap
        if prompt_len_range is not None:
            lo, hi = prompt_len_range
            plen = int(rng.integers(lo, hi + 1))
        else:
            plen = prompt_len
        toks = rng.integers(0, vocab_size, (plen,)).astype(np.int32)
        out.append(Request(rid=rid_base + i, tokens=toks,
                           max_new_tokens=max_new_tokens,
                           arrival_time=t, eos_id=eos_id))
    return out


def split_seeds(seed: int, n: int) -> List[int]:
    """n statistically independent child seeds spawned from one root seed
    (``numpy.random.SeedSequence.spawn``) — one per replica / sub-stream,
    so a multi-replica fleet run is replayable from a single seed and no
    two sub-streams share an underlying bit stream (unlike ``seed + i``
    offsets, which can correlate)."""
    return [int(ss.generate_state(1)[0])
            for ss in np.random.SeedSequence(seed).spawn(n)]


def merge_requests(*streams: Sequence[Request]) -> List[Request]:
    """Merge per-replica/per-group sub-streams into one arrival-ordered
    trace.  Stable on arrival-time ties (earlier stream first), so the
    merged order is deterministic given deterministic sub-streams.  Rids
    are left untouched — generate sub-streams with disjoint ``rid_base``
    ranges."""
    out = [r for s in streams for r in s]
    rids = [r.rid for r in out]
    if len(set(rids)) != len(rids):
        raise ValueError("merged request streams have colliding rids; "
                         "generate sub-streams with disjoint rid_base")
    return sorted(out, key=lambda r: r.arrival_time)


def trace_requests(records: Iterable[dict], *, vocab_size: int,
                   seed: int = 0) -> List[Request]:
    """Requests from trace records: dicts with ``arrival_time``,
    ``prompt_len`` (or explicit ``tokens``), and ``max_new_tokens``."""
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for i, rec in enumerate(records):
        if "tokens" in rec:
            toks = np.asarray(rec["tokens"], np.int32)
        else:
            toks = rng.integers(0, vocab_size,
                                (int(rec["prompt_len"]),)).astype(np.int32)
        out.append(Request(
            rid=int(rec.get("rid", i)), tokens=toks,
            max_new_tokens=int(rec.get("max_new_tokens", 16)),
            arrival_time=float(rec.get("arrival_time", 0.0)),
            eos_id=rec.get("eos_id")))
    return out


def load_trace(path: str, *, vocab_size: int) -> List[Request]:
    """JSON trace file: a list of record dicts (see ``trace_requests``)."""
    with open(path) as f:
        return trace_requests(json.load(f), vocab_size=vocab_size)


class AdmissionQueue:
    """Arrival-time-ordered queue; FIFO among already-arrived requests."""

    def __init__(self, requests: Sequence[Request] = ()):
        self._heap: List[Tuple[float, int, Request]] = []
        self._n = 0
        for r in requests:
            self.push(r)

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (req.arrival_time, self._n, req))
        self._n += 1

    def __len__(self) -> int:
        return len(self._heap)

    def next_arrival(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def peek_ready(self, now: float) -> Optional[Request]:
        """The earliest already-arrived request, left in the queue."""
        if self._heap and self._heap[0][0] <= now:
            return self._heap[0][2]
        return None

    def pop_ready(self, now: float) -> Optional[Request]:
        if self._heap and self._heap[0][0] <= now:
            return heapq.heappop(self._heap)[2]
        return None
