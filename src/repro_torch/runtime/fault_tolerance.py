"""Fault-tolerance runtime: failure injection, resume orchestration, and the
straggler-mitigation story.

The port's own copy of ``repro/runtime/fault_tolerance.py`` (plain
Python); ``python -m repro_torch.launch.train`` reads
``REPRO_FAIL_AT_STEP`` through ``FailureInjector.from_env``.

At 1000+ node scale the failure model is: any worker can die at any step; the
job restarts (same or reduced mesh) and must resume bit-exact from the last
committed checkpoint. The pieces here + checkpoint/checkpointer.py implement
that contract; tests/test_torch_checkpoint.py kills a training loop mid-run
and verifies the resumed loss trajectory matches an uninterrupted run.

Straggler mitigation layers (DESIGN.md §3):
  * token level  — the HarMoEny scheduler itself: the max-loaded EP rank
    bounds the MoE layer's critical path, and rebalancing minimizes it;
  * input level  — host-thread prefetch (data/pipeline.py);
  * step level   — persistent stragglers are handled by a restart from
    the last committed checkpoint.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically kill the loop at a given step (tests/examples)."""
    fail_at_step: Optional[int] = None

    @staticmethod
    def from_env() -> "FailureInjector":
        v = os.environ.get("REPRO_FAIL_AT_STEP")
        return FailureInjector(int(v) if v else None)

    def check(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_restarts(make_loop: Callable[[], int], *, max_restarts: int = 3
                      ) -> int:
    """Drive a resumable loop through injected/real failures.

    ``make_loop`` runs training from the latest checkpoint and returns the
    final step; on failure it is re-invoked (fresh process state would be the
    real-cluster equivalent)."""
    attempts = 0
    while True:
        try:
            return make_loop()
        except InjectedFailure:
            attempts += 1
            if attempts > max_restarts:
                raise
