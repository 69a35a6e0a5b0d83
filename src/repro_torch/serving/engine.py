"""Pieces of the JAX package's ``serving/engine.py`` that the paged
engine shares: the round-limit error, the virtual step clock and the
admission round. The rest of that file (the dense ring-cache engine)
waits for a later slice of the port.
"""
from __future__ import annotations

from repro_torch.core.scheduler import RoundBudget


class RoundLimitExceeded(RuntimeError):
    """``run_to_completion`` exhausted its round budget with work still
    live. Raised instead of returning normally so a scheduler live-lock
    (or a turn that never finishes) can't masquerade as a completed run
    in tests and benchmarks."""


def schedule_round(scheduler, kv, clock, slot_state, act, token_budget, *,
                   block_size: int = 16):
    """One admission round, shared by both engines: free KV plus
    reclaimable idle KV (eviction frees it on demand) against the token
    budget. Returns (scheduled slot ids, per-slot token grants) — the
    scheduler's ``chunk_for`` decision, so a PREFILL slot's chunk grant
    survives the trip through the self-scheduled path (the dense engine
    ignores the grants; its slots are always DECODE)."""
    budget = RoundBudget(
        token_budget=token_budget,
        free_kv_blocks=kv.free_blocks
        + kv.reclaimable_blocks(clock.now()),
        block_size=block_size)
    decision = scheduler.schedule([s.request for s in act], budget,
                                  clock.now())
    sched_ids = {r.req_id: decision.chunks[r.req_id]
                 for r in decision.batch}
    slots = [i for i, s in slot_state.items()
             if s and s.request.req_id in sched_ids]
    return slots, {i: sched_ids[slot_state[i].request.req_id]
                   for i in slots}


class _StepClock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt: float = 0.01):
        self.t += dt

    def now(self):
        return self.t
