"""Fault tolerance for the serving fleet (DESIGN.md §8, §12).

- ``StragglerMitigator``: per-round deadline tracking for the serving
  engines — a round exceeding ``deadline_factor`` x the rolling median
  marks the source straggling; the fleet router drains a replica that
  keeps straggling and lifts the drain once it recovers.

The reference module's ``run_resilient`` (checkpoint/restart) and
``elastic_rescale`` (re-place checkpointed state on a resized mesh)
belong to training and wait for its port (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class StragglerMitigator:
    """Per-round deadline tracking with a genuine recovery path.

    A round exceeding ``deadline_factor`` x the rolling median earns the
    source a strike. A single round back under the deadline does NOT
    erase the record — an alternating slow/fast straggler must still
    accumulate — but ``recover_after`` *consecutive* under-deadline
    rounds reset the source to a clean slate. ``forget`` drops a source
    that was drained/replaced so its history cannot leak onto a fresh
    replica reusing the name.
    """
    deadline_factor: float = 3.0
    window: int = 32
    min_samples: int = 8
    recover_after: int = 2
    durations: List[float] = field(default_factory=list)
    strikes: dict = field(default_factory=dict)
    good_streak: dict = field(default_factory=dict)

    def observe(self, source: str, duration_s: float) -> bool:
        """Record a round duration; True if `source` is straggling."""
        self.durations.append(duration_s)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        med = float(np.median(self.durations))
        if (len(self.durations) >= self.min_samples
                and duration_s > self.deadline_factor * med):
            self.strikes[source] = self.strikes.get(source, 0) + 1
            self.good_streak.pop(source, None)
            return True
        if source in self.strikes:
            streak = self.good_streak.get(source, 0) + 1
            if streak >= self.recover_after:
                self.forget(source)
            else:
                self.good_streak[source] = streak
        return False

    def should_evict(self, source: str, threshold: int = 3) -> bool:
        return self.strikes.get(source, 0) >= threshold

    def forget(self, source: str) -> None:
        """Clean slate for ``source`` (drained / replaced replica)."""
        self.strikes.pop(source, None)
        self.good_streak.pop(source, None)
