"""Admission/scheduling front of the serving engine.

``AdmissionFront`` owns the request-side scheduling state: the arrival
queue, the free-slot pool, per-slot request states, the prefill pipeline
(in-flight chunked prefill plus the slot-reserved waiting line), and the
preempted-recompute queue.  It runs the admission loop — preempted
requests first, then arrivals in order, each gated by the caller's
block-reservation plan — but delegates *placement* (slot assignment, KV
chain allocation) back to the engine, which knows the pool.

A fleet router reads a replica's load here without touching its device
state: ``queued_tokens()`` totals the prefill work parked at the front
(queued prompts, reserved-but-unprefilled tails, preempted recompute),
the router's half of the load score.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Tuple

from repro_torch.serve.arrivals import AdmissionQueue
from repro_torch.serve.request import RequestState


class AdmissionFront:
    def __init__(self, max_slots: int):
        self.queue = AdmissionQueue()
        self.free_slots: deque = deque(range(max_slots))
        self.state_by_slot: List[Optional[RequestState]] = [None] * max_slots
        self.slot_history: List[Tuple[int, int]] = []  # (rid, slot) admits
        self.pf: Optional[RequestState] = None       # prefill in flight
        self.pf_queue: deque = deque()               # slot reserved, waiting
        self.resume: deque = deque()                 # preempted, to recompute
        self.admit_seq = 0

    # ------------------------------------------------------------------
    def in_flight(self, active_any: bool) -> bool:
        """Admitted work whose timestamps already live on the current clock
        (queued-but-unadmitted requests carry none — their arrival_time is
        relative to the measurement window, not the clock origin).
        Preempted requests hold timestamps too."""
        return bool(self.pf is not None or self.pf_queue or self.resume
                    or active_any)

    def queued_tokens(self) -> int:
        """Prefill tokens waiting at this front: queued prompts plus the
        unconsumed tails of reserved, in-flight and preempted prefills."""
        total = self.queue.queued_tokens()
        pending = list(self.pf_queue) + list(self.resume)
        if self.pf is not None:
            pending.append(self.pf)
        for st in pending:
            total += max(st.prefill_len - st.prefill_pos, 0)
        return total

    # ------------------------------------------------------------------
    def admit(self, now: float, *, plan_fn: Callable[[object, bool], tuple],
              can_admit_fn: Callable[[tuple], bool],
              place_fn: Callable[[RequestState, tuple], None]) -> None:
        """Fill free slots: preempted recompute first (oldest first), then
        arrivals in queue order.  Admission is gated on the block plan
        (``plan_fn(tokens, resumed)``: the shared prefix and the fresh
        blocks needed) for each candidate; the loop stops at the first
        candidate that does not fit, preserving FIFO fairness."""
        while self.free_slots:
            if self.resume:
                st = self.resume[0]
                plan = plan_fn(st.prefill_tokens, st.resumed)
                if not can_admit_fn(plan):
                    return
                self.resume.popleft()
                place_fn(st, plan)
                continue
            req = self.queue.peek_ready(now)
            if req is None:
                return
            plan = plan_fn(req.tokens, False)
            if not can_admit_fn(plan):
                return
            self.queue.pop_ready(now)
            place_fn(RequestState(req=req, slot=-1, admitted_time=now), plan)
