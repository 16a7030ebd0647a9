"""Request abstractions for the continuous-batching serving engine.

A ``Request`` is what a client submits: prompt tokens plus generation
limits and an arrival time (assigned by the arrival process). The engine
wraps each admitted request in a ``RequestState`` that tracks its slot,
progress, and the timestamps the metrics layer turns into TTFT/TPOT.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"        # waiting for a free slot
    PREFILL = "prefill"      # slot reserved, prompt chunks being consumed
    DECODE = "decode"        # in the decode batch, emitting tokens
    FINISHED = "finished"    # EOS or max_new_tokens reached
    HANDED_OFF = "handed_off"  # prefill-role engine exported the KV +
    #                            first token; a decode-role engine owns
    #                            the request from here


@dataclass
class Request:
    """One generation request.

    ``tokens`` is the prompt as int32 token ids; ``max_new_tokens`` bounds
    generation (the first token produced by prefill counts toward it);
    ``arrival_time`` is seconds on the engine clock (0 = already waiting).
    """
    rid: int
    tokens: np.ndarray
    max_new_tokens: int = 16
    arrival_time: float = 0.0
    eos_id: Optional[int] = None

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class RequestState:
    """Engine-side bookkeeping for one admitted request.

    A state preempted by the paged engine (its KV blocks reclaimed) goes
    back to the scheduler and is later *recomputed*: prefill re-runs over
    the prompt plus every committed output token except the last, whose
    K/V was never written — ``prefill_tokens`` is exactly that sequence.
    For a fresh request (no output yet) it degenerates to the prompt.
    """
    req: Request
    slot: int
    status: RequestStatus = RequestStatus.PREFILL
    prefill_pos: int = 0                 # prefill tokens consumed so far
    output: List[int] = field(default_factory=list)
    n_preempted: int = 0                 # times evicted for recompute
    admit_seq: int = 0                   # admission order (preemption age)
    # --- timestamps on the engine clock ---
    admitted_time: float = 0.0           # slot reserved / prefill started
    first_token_time: float = 0.0        # last prefill chunk done (TTFT point)
    finish_time: float = 0.0
    # --- prefix sharing ---
    cached_prefix_tokens: Optional[int] = None  # prefill skipped at first
    #                                             admission via a cache hit
    prefix_loaded: bool = False          # cached prefix gathered to scratch

    @property
    def n_generated(self) -> int:
        return len(self.output)

    @property
    def resumed(self) -> bool:
        """Re-admitted after preemption: decode state must be rebuilt."""
        return bool(self.output)

    @property
    def prefill_tokens(self) -> np.ndarray:
        """Token sequence the (re)prefill consumes."""
        if not self.output:
            return self.req.tokens
        return np.concatenate([self.req.tokens,
                               np.asarray(self.output[:-1], np.int32)])

    @property
    def prefill_len(self) -> int:
        return self.req.prompt_len + max(self.n_generated - 1, 0)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.prefill_len
