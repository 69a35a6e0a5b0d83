"""Virtual clock + event queue for the discrete-event serving harness."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class VirtualClock:
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        assert t >= self._now - 1e-9, (t, self._now)
        self._now = max(self._now, t)


class EventQueue:
    def __init__(self, clock: VirtualClock):
        self.clock = clock
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()

    def push(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def push_in(self, dt: float, fn: Callable) -> None:
        self.push(self.clock.now() + dt, fn)

    def empty(self) -> bool:
        return not self._heap

    def run(self, until: float = float("inf"), max_events: int = 10_000_000):
        n = 0
        while self._heap and n < max_events:
            t, _, fn = heapq.heappop(self._heap)
            if t > until:
                self.clock.advance_to(until)
                return
            self.clock.advance_to(t)
            fn()
            n += 1
        if n >= max_events:
            raise RuntimeError("event budget exceeded — likely a live-lock")
