"""Fault tolerance (DESIGN.md §8, §12).

- ``run_resilient``: the checkpoint/restart supervisor of training — a
  (simulated or real) failure restarts training from the last atomic
  checkpoint.
- ``elastic_rescale``: the newest checkpoint re-placed on a rebuilt
  (resized) mesh, each rank reading its own blocks of the full leaves
  (``restore_checkpoint(shardings=)``); the optimizer state follows
  the parameters' specs, and the next step's batch is cut by the new
  mesh's rules.
- ``StragglerMitigator``: per-round deadline tracking for the serving
  engines — a round exceeding ``deadline_factor`` x the rolling median
  marks the source straggling; the fleet router drains a replica that
  keeps straggling and lifts the drain once it recovers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.training.checkpoint import restore_checkpoint


def run_resilient(train_once: Callable[[int], int], *, max_restarts: int = 3,
                  on_failure: Optional[Callable] = None) -> int:
    """Run ``train_once(start_step) -> last_step`` with restart-on-failure.

    ``train_once`` is expected to checkpoint; a raised exception triggers
    restore-from-latest and retry (the checkpoint/restart contract):
    ``on_failure(exc, restarts)`` returns the step to start again from.
    """
    restarts = 0
    start = 0
    while True:
        try:
            return train_once(start)
        except Exception as e:           # noqa: BLE001 — supervisor
            restarts += 1
            if on_failure is not None:
                start = on_failure(e, restarts)
            if restarts > max_restarts:
                raise


def elastic_rescale(ckpt_dir: str, make_mesh: Callable, make_shardings:
                    Callable, *, device=None):
    """Restore the newest checkpoint under ``ckpt_dir`` onto the mesh
    ``make_mesh()`` returns for this rank (every rank of it calls this):
    each leaf this rank's block under ``make_shardings(mesh)``'s rules
    (a ``ShardingRules``), on ``device`` where given. Returns (tree,
    step, mesh).

    The reference's ``make_shardings(mesh, tree)`` returns a tree of
    ``NamedSharding``s for ``device_put``; here the rules alone say
    which block of each full leaf a rank holds, and the checkpoint's
    files are mapped, so no rank reads a whole leaf it does not keep."""
    mesh = make_mesh()
    tree, step = restore_checkpoint(ckpt_dir, device=device,
                                    shardings=(make_shardings(mesh), mesh))
    return tree, step, mesh


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
