"""Clocks and the admission queue (port of the parts of
``repro/serve/arrivals.py`` the engine uses).

The engine reads time from a clock: ``WallClock`` for real serving,
``VirtualClock`` for deterministic tests (each ``now()`` advances a fixed
dt, so arrival draining always terminates).
"""
from __future__ import annotations

import heapq
import time
from typing import List, Optional, Sequence, Tuple

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
