"""Real-model realtime engine on the ring-cache model (the port of the
JAX package's ``serving/engine.py``), and the pieces the paged engine
shares with it: the round-limit error, the virtual step clock and the
admission round.

``RealtimeLLMEngine`` drives the model's ``prefill`` and slot-batched
``decode_step`` under the LiveServe control plane: each round the
UrgencyScheduler picks which sessions advance; unscheduled slots are
held by rewinding their cache length (their KV slot is overwritten on
the next committed step), so scheduling moves *when* tokens appear,
never *which*. The host logic is the reference's, line for line; the
reference's functional cache updates become in-place writes into the
one cache, and its ``jax.jit`` has no counterpart (PyTorch runs
eagerly). Two faults of the reference are not carried over (ROADMAP
queue 3): its graft writes layer 0's prefill cache into every layer of
the slot, and a held slot's recurrent state (ssm, rglru) advances with
the step. A held slot's token is not routed by the moe layers either,
so it takes no expert capacity from the scheduled ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kv_manager import KVManager
from repro_torch.core.monitor import RuntimeMonitor
from repro_torch.core.scheduler import RoundBudget, SchedulerConfig, \
    UrgencyScheduler
from repro_torch.core.session import Phase, Request, RequestState
from repro_torch.device import resolve_device
from repro_torch.models.model import decode_step, init_cache, prefill


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


# the cache leaves a decode step advances in place of a ring slot: the
# ssm layers' and the hybrid's rglru layers'
RECURRENT = ("conv_x", "conv_bc", "ssm_state", "rec_h", "rec_conv")


@dataclass
class SlotState:
    session_id: str
    request: Request
    pending_token: int              # next token to feed
    tokens: List[int] = field(default_factory=list)
    working_blocks: int = 0         # KV blocks actually acquired


class RealtimeLLMEngine:
    def __init__(self, cfg, params, *, slots: int = 4, capacity: int = 256,
                 clock=None, scheduler: Optional[UrgencyScheduler] = None,
                 kv: Optional[KVManager] = None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.capacity = capacity
        self.clock = clock or _StepClock()
        self.monitor = RuntimeMonitor(self.clock)
        self.kv = kv or KVManager(
            capacity_blocks=slots * (capacity // 16) * 2, block_size=16,
            bytes_per_token=1024.0, monitor=self.monitor, clock=self.clock)
        self.scheduler = scheduler or UrgencyScheduler(
            SchedulerConfig(), self.monitor, stage="thinker",
            kv_occupancy=self.kv.occupancy)
        self.cache = init_cache(cfg, slots, capacity, self.device)
        self.slot_state: Dict[int, Optional[SlotState]] = {
            i: None for i in range(slots)}

    # ------------------------------------------------------------ admit
    def free_slot(self) -> Optional[int]:
        for i, s in self.slot_state.items():
            if s is None:
                return i
        return None

    def add_session(self, session_id: str, prompt: np.ndarray,
                    max_new_tokens: int) -> int:
        """Prefill the prompt into a free slot; returns the slot id."""
        slot = self.free_slot()
        assert slot is not None, "no free decode slot"
        self.monitor.register(session_id)
        prompt = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device)[None, :]
        # slot-isolated prefill: run a B=1 prefill then graft into the
        # slot's row of every cache leaf (of every layer: the reference's
        # graft writes layer 0's row into all layers, ROADMAP queue 3)
        c1 = init_cache(self.cfg, 1, self.capacity, self.device)
        logits, c1 = prefill(self.cfg, self.params, prompt, c1)
        for name, one in c1.items():
            idx = _slot_index(self.cache[name], self.slots, slot)
            self.cache[name][idx] = one[idx[:-1] + (0,)]
        _set_len(self.cache, slot, int(c1["len"][0]))
        req = Request(session_id=session_id, stage="thinker", turn_index=0,
                      arrival_time=self.clock.now(),
                      prompt_len=int(prompt.shape[1]),
                      max_new_tokens=max_new_tokens)
        req.phase = Phase.DECODE
        req.prefilled = req.prompt_len
        self.kv.pin(session_id)
        blocks = self.kv.blocks_of(req.prompt_len)
        got = blocks if self.kv.try_allocate_working(
            blocks, self.clock.now()) else 0
        tok = int(torch.argmax(logits[0]))
        self.slot_state[slot] = SlotState(session_id, req, tok, [tok],
                                          working_blocks=got)
        return slot

    def abort(self, session_id: str) -> None:
        """Barge-in: drop the in-flight request, keep committed KV."""
        for i, s in self.slot_state.items():
            if s and s.session_id == session_id:
                s.request.state = RequestState.ABORTED
                self._commit(s)
                self.slot_state[i] = None

    def _commit(self, s: SlotState) -> None:
        """Turn over: the working allocation becomes committed session
        KV (releasing both would double-count the same blocks). Only
        blocks actually acquired are released — an allocation that
        failed at admission must not drain other sessions' share."""
        self.kv.release_working(s.working_blocks)
        self.kv.commit_turn(s.session_id, s.request.total_context,
                            self.clock.now())

    # ------------------------------------------------------------ rounds
    def active(self) -> List[SlotState]:
        return [s for s in self.slot_state.values()
                if s is not None and s.request.is_live()
                and s.request.generated < s.request.max_new_tokens]

    def step(self) -> List[int]:
        """One scheduling round + one batched decode. Returns scheduled
        slot ids."""
        self.clock.tick()
        act = self.active()
        if not act:
            return []
        sched_slots, _ = schedule_round(self.scheduler, self.kv,
                                        self.clock, self.slot_state, act,
                                        self.slots)
        if not sched_slots:
            return []
        tokens = torch.tensor(
            [self.slot_state[i].pending_token
             if self.slot_state[i] else 0 for i in range(self.slots)],
            dtype=torch.int64, device=self.device)
        mask = np.zeros((self.slots,), bool)
        mask[sched_slots] = True
        # a held slot's recurrent state (ssm, rglru) must not advance
        # either: the reference rewinds only the length (ROADMAP queue 3)
        held = torch.from_numpy(np.flatnonzero(~mask)).to(self.device)
        kept = {k: self.cache[k][:, held].clone() for k in RECURRENT
                if k in self.cache and held.numel()}
        logits, self.cache = decode_step(
            self.cfg, self.params, tokens, self.cache,
            valid=torch.from_numpy(mask).to(self.device))
        # hold unscheduled slots: rewind their cache length by one (their
        # stale KV entry is overwritten the next time they are scheduled)
        self.cache["len"] -= torch.from_numpy(~mask).to(self.device,
                                                         torch.int32)
        for k, rows in kept.items():
            self.cache[k][:, held] = rows
        nxt = torch.argmax(logits, dim=-1).cpu()
        for i in sched_slots:
            s = self.slot_state[i]
            s.request.generated += 1
            if s.request.first_output_time is None:
                s.request.first_output_time = self.clock.now()
            tok = int(nxt[i])
            s.pending_token = tok
            if s.request.generated < s.request.max_new_tokens:
                s.tokens.append(tok)
            else:
                s.request.state = RequestState.FINISHED
                self._commit(s)
        return sched_slots

    def run_to_completion(self, max_rounds: int = 10_000) -> Dict[str, list]:
        for _ in range(max_rounds):
            if not self.active():
                break
            self.step()
        if self.active():
            raise RoundLimitExceeded(
                f"{len(self.active())} slots still live after "
                f"{max_rounds} rounds")
        return {s.session_id: s.tokens
                for s in self.slot_state.values() if s is not None}


# ---------------------------------------------------------------- helpers
class _StepClock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt: float = 0.01):
        self.t += dt

    def now(self):
        return self.t


def _slot_index(buf, slots: int, slot: int):
    """Cache leaves are [L, B, ...] or [B, ...]; find the B axis."""
    if buf.ndim >= 2 and buf.shape[1] == slots:
        return (slice(None), slot)
    return (slot,)


def _set_len(cache, slot: int, value: int):
    cache["len"][slot] = value
    return cache
