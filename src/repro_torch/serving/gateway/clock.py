"""Scaled wall clock — real time for the whole serving stack
(DESIGN.md §4).

The control plane (monitor, scheduler, KV manager, preloader) is
clock-agnostic: it reads ``clock.now()``. Under the simulator that is a
virtual clock; under the gateway it is this one — monotonic wall time
multiplied by ``scale`` so a 2.5 s utterance takes 2.5/scale real
seconds while every policy still sees paper-scale durations (playback
drains at 1 clock-second per clock-second by construction).

``tick(dt)`` keeps the engines' modelled-cost contract: synchronous
paths charge modelled time (e.g. the on-path KV reload residual from the
TransferChannel) by advancing a constant offset — time the data plane
did not physically spend but the policy plane must account for. Real
compute (prefill/decode steps) advances the clock by actually taking
wall time, so the engine's default per-round ``tick()`` is a no-op here.
"""
from __future__ import annotations

import asyncio
import time


class ScaledWallClock:
    def __init__(self, scale: float = 1.0):
        assert scale > 0.0
        self.scale = scale
        self._t0 = time.perf_counter()
        self._offset = 0.0

    def now(self) -> float:
        """Scaled seconds since construction, plus modelled-cost offset."""
        return (time.perf_counter() - self._t0) * self.scale + self._offset

    def tick(self, dt: float = 0.0) -> None:
        """Charge ``dt`` scaled seconds of modelled (non-physical) cost.
        The engines call ``tick()`` once per round purely to advance
        step clocks; under wall time that is free, hence default 0."""
        self._offset += dt

    async def sleep(self, dt_s: float) -> None:
        """Sleep ``dt_s`` *scaled* seconds (dt_s / scale real seconds)."""
        if dt_s > 0:
            await asyncio.sleep(dt_s / self.scale)

    def real_s(self, dt_s: float) -> float:
        """Convert a scaled-clock duration to real seconds."""
        return dt_s / self.scale

    def restart(self) -> None:
        """Rewind to t=0 — called once after engine warm-up so the jit
        compile's wall time doesn't pollute serving metrics."""
        self._t0 = time.perf_counter()
        self._offset = 0.0
