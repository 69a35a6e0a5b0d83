"""Interaction-aware request scheduling (paper §4, Algorithm 1).

Urgency classes per scheduling round:
  U0 playback urgency   — started playback, buffer <= P_safe; sort buffer asc.
  U1 first-audio        — no first output yet; sort by ready age (FCFS aging).
  U2 efficiency         — utility U = beta*U_kv - alpha*C_barge (Eqs. 1-3),
                          sorted descending.

Batch formation scans Concat(U0, U1, U2) against the round budgets
(token budget + free KV blocks). Fail-closed: a request whose session has
no playback telemetry classifies as U1 (first-audio path) and missing U2
utility inputs reduce U2 to ready-age order — matching §6.

The scheduler is clock-agnostic: ``now`` is whatever the caller's clock
says, so the same Algorithm 1 runs under the simulator's virtual clock
and the realtime gateway's scaled wall clock (DESIGN.md §4). Pacing
(class 3) is the playback-frontier generation cap: a session whose
client buffer exceeds ``p_max_s`` is held until the buffer drains, so
decode never runs more than the configured margin ahead of playback.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.core.session import Phase, Request


@dataclass
class SchedulerConfig:
    p_safe_s: float = 1.0            # minimum safe playback buffer (s)
    p_max_s: float = 3.0             # pacing cap: hold U2 beyond this buffer
    alpha: float = 1.0               # barge-in exposure weight (Eq. 1)
    beta: float = 1.0                # KV-pressure relief weight (Eq. 1)
    enable_urgency: bool = True      # False -> pure FCFS (baseline)
    enable_u2_utility: bool = True   # False -> U2 by ready age (ablation)
    enable_pacing: bool = True       # False -> never hold far-ahead work
    pacing_kv_override: float = 0.9  # KV occupancy beyond which far-ahead
    #   sessions run anyway (KV-pressure relief beats pacing — the paper's
    #   alpha/beta tradeoff under memory pressure, §4.1 / Fig. 8)


@dataclass
class RoundBudget:
    token_budget: int                # prefill+decode tokens this round
    free_kv_blocks: int              # allocatable KV blocks at this stage
    max_batch: int = 256
    block_size: int = 16
    # batch rows available for NEW bindings this round (None = untracked).
    # A queued turn (``req.slot_bound`` False) needs one to enter the
    # engine; without this credit an urgent queued turn could outrank
    # every live decode slot yet bind nowhere — eating the whole batch
    # while the slots it is waiting on are never scheduled to finish
    free_slots: Optional[int] = None

    def need_blocks(self, req: Request, chunk: int) -> int:
        """KV blocks this round actually allocates: prefill chunks round
        up; a decode token needs a new block only when its position
        crosses a block boundary — charging one per token would let a
        full pool of live sessions starve decode that needs no growth."""
        if req.phase == Phase.DECODE:
            # blocks newly crossed by growing tc -> tc + chunk (chunk==1
            # reduces to the old boundary test: 1 iff tc % bs == 0)
            tc, bs = req.total_context, self.block_size
            return (tc + chunk + bs - 1) // bs - (tc + bs - 1) // bs
        return -(-chunk // self.block_size)

    def fits(self, req: Request, chunk: int) -> bool:
        if self.max_batch <= 0:
            return False
        if chunk > self.token_budget:
            return False
        return self.need_blocks(req, chunk) <= self.free_kv_blocks

    def admit(self, req: Request, chunk: int) -> None:
        self.token_budget -= chunk
        self.free_kv_blocks -= self.need_blocks(req, chunk)
        self.max_batch -= 1


@dataclass
class ScheduleDecision:
    batch: List[Request]
    chunks: dict                     # req_id -> tokens this round
    classes: dict                    # req_id -> 0/1/2/3 (telemetry/debug)
    utilities: dict = field(default_factory=dict)
    held: list = field(default_factory=list)   # (req, buffer) paced out


class UrgencyScheduler:
    """One instance per stage engine (stage-specific buffer estimator)."""

    def __init__(self, cfg: SchedulerConfig, monitor, *,
                 stage: str,
                 buffer_estimator: Optional[Callable] = None,
                 kv_occupancy: Optional[Callable] = None,
                 kv_of_request: Optional[Callable] = None,
                 prefill_chunk: int = 512,
                 decode_chunk: int = 1):
        self.cfg = cfg
        self.monitor = monitor
        self.stage = stage
        self._buffer = buffer_estimator or self._default_buffer
        self._kv_occ = kv_occupancy or (lambda: 0.0)
        self._kv_of = kv_of_request or (lambda r: float(r.total_context))
        self.prefill_chunk = prefill_chunk
        # decode grant per round: 1 + draft budget under speculative
        # decode (DESIGN.md §16). Callers must clamp this to the round
        # token budget — a grant the budget can never fit would stall
        # at Algorithm 1's admission break every round (head-of-line)
        self.decode_chunk = decode_chunk

    # ------------------------------------------------------------ signals
    def _default_buffer(self, req: Request) -> Optional[float]:
        """Stage-aware playback buffer P_i^s (audio stages: client buffer)."""
        return self.monitor.playback_buffer_s(req.session_id)

    def classify(self, req: Request, now: float):
        """Returns (class, sort_key, buffer). class 3 = held (pacing)."""
        cfg = self.cfg
        buf = self._buffer(req)
        view = self.monitor.view(req.session_id)
        deadline = getattr(view, "frame_deadline", None) \
            if view is not None else None
        if deadline is not None:
            # periodic-frame (full-duplex) session: urgency is the
            # slack to the next frame deadline, not the playback buffer
            # — a frame due within P_safe joins U0 (its key, seconds
            # until trouble, sorts compatibly with buffer seconds)
            slack = deadline - now
            if slack <= cfg.p_safe_s:
                return 0, slack, buf
        started = bool(view and view.playback.started
                       and not view.playback.complete)
        if not started or buf is None:
            # no first playable audio packet yet for this turn (U1), or
            # telemetry missing (fail-closed -> first-audio path)
            return 1, now - req.arrival_time, buf
        if buf <= cfg.p_safe_s:
            return 0, buf, buf
        if cfg.enable_pacing and buf > cfg.p_max_s \
                and self._kv_occ() < cfg.pacing_kv_override:
            # generation far beyond the playback frontier: delay (§4)
            return 3, buf, buf
        return 2, 0.0, buf

    def utility(self, req: Request, buf: Optional[float]) -> float:
        """Eq. 1: U = beta * U_kv - alpha * C_barge."""
        cfg = self.cfg
        if not cfg.enable_u2_utility or buf is None:
            return 0.0
        c_barge = max(0.0, buf - cfg.p_safe_s) / max(cfg.p_safe_s, 1e-9)
        u_kv = self._kv_of(req) * self._kv_occ()
        return cfg.beta * u_kv - cfg.alpha * c_barge

    # ------------------------------------------------------------ rounds
    def chunk_for(self, req: Request) -> int:
        if req.phase == Phase.PREFILL and not req.done_prefill:
            return min(self.prefill_chunk, req.prompt_len - req.prefilled)
        # decode: pending token + up to decode_chunk-1 draft tokens,
        # never past the turn's remaining generation budget
        return max(1, min(self.decode_chunk,
                          req.max_new_tokens - req.generated))

    def schedule(self, ready: List[Request], budget: RoundBudget,
                 now: float) -> ScheduleDecision:
        classes, utilities = {}, {}
        held = []
        if not self.cfg.enable_urgency:
            order = sorted(ready, key=lambda r: (r.arrival_time, r.req_id))
        else:
            c0, c1, c2 = [], [], []
            for r in ready:
                cls, key, buf = self.classify(r, now)
                classes[r.req_id] = cls
                if cls == 0:
                    c0.append((key, r.req_id, r))
                elif cls == 1:
                    c1.append((-key, r.req_id, r))   # oldest first
                elif cls == 3:
                    held.append((r, key))            # paced out this round
                else:
                    u = self.utility(r, buf)
                    utilities[r.req_id] = u
                    c2.append((-u, r.req_id, r))
            c0.sort(key=lambda t: t[:2])
            c1.sort(key=lambda t: t[:2])
            c2.sort(key=lambda t: t[:2])
            order = [t[2] for t in c0 + c1 + c2]

        batch, chunks = [], {}
        for r in order:
            needs_slot = budget.free_slots is not None \
                and not r.slot_bound
            if needs_slot and budget.free_slots <= 0:
                # no batch row can bind this turn: skip, don't break —
                # slots are a different resource from the token budget,
                # and stopping here would starve the live decode slots
                # this very turn is waiting on (head-of-line livelock)
                continue
            chunk = self.chunk_for(r)
            if not budget.fits(r, chunk):
                break                 # Algorithm 1: admission stops
            budget.admit(r, chunk)
            if needs_slot:
                budget.free_slots -= 1
            batch.append(r)
            chunks[r.req_id] = chunk
            r.last_scheduled = now
        return ScheduleDecision(batch=batch, chunks=chunks, classes=classes,
                                utilities=utilities, held=held)

    def hold_wake_s(self, decision: ScheduleDecision,
                    now: Optional[float] = None) -> Optional[float]:
        """How long (in clock seconds) until the earliest pace-held
        session drains back to the pacing threshold — playback consumes
        buffer at 1 s/s, so a driver with nothing else to run can sleep
        this long instead of spinning. None when nothing is held.

        With ``now``, a held periodic-frame session also bounds the wake
        by its frame slack: the driver must be back before the deadline
        slack shrinks to P_safe (when classify promotes the session to
        U0), so a hold can never turn into a frame miss by itself."""
        if not decision.held:
            return None
        wakes = []
        for req, buf in decision.held:
            wake = buf - self.cfg.p_max_s
            if now is not None:
                view = self.monitor.view(req.session_id)
                deadline = getattr(view, "frame_deadline", None) \
                    if view is not None else None
                if deadline is not None:
                    wake = min(wake, deadline - now - self.cfg.p_safe_s)
            wakes.append(max(0.01, wake))
        return min(wakes)


class FCFSScheduler(UrgencyScheduler):
    """Baseline: vLLM-Omni default ordering."""

    def __init__(self, monitor, *, stage: str, **kw):
        super().__init__(SchedulerConfig(enable_urgency=False), monitor,
                         stage=stage, **kw)
