"""The realtime session gateway (DESIGN.md §4).

An asyncio front-end holding many concurrent duplex sessions against one
``PagedRealtimeEngine``. The inversion that matters: the *control plane*
owns the step loop. Each round the gateway

1. drains client events (speech, turn requests, barge-in, hangup) into
   the monitor/preloader — the interaction plane;
2. builds the candidate set: every live slot request plus every queued
   turn not yet bound to a slot, minus decode slots past the hard
   playback-frontier cap;
3. asks ``core/scheduler.py`` (Algorithm 1) for the round's admission:
   which turns attach to slots, which slots advance, what prefill chunk
   each gets, who is pace-held behind the playback frontier;
4. executes exactly that decision via ``engine.run_round`` and streams
   the resulting audio chunks back to clients, feeding each session's
   playback clock (``monitor.on_audio``).

The engine never schedules for itself here — ``engine.step()`` is the
self-driving demo path; the gateway calls ``submit_turn``/``run_round``
with its own scheduler's output, so the same Algorithm 1 implementation
that runs under the simulator's virtual clock runs against real paged
device state under a scaled wall clock.

Single-threaded asyncio discipline: every engine call happens on the
event loop with no await inside, so rounds, barge-in aborts, and turn
admissions are atomic with respect to each other — that is the
"async-safe" contract, not locks.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import (FCFSScheduler, RoundBudget,
                                        SchedulerConfig, UrgencyScheduler)
from repro_torch.core.session import Phase, Request, RequestState
from repro_torch.kvcache.paged import OutOfPages
from repro_torch.serving.gateway.clock import ScaledWallClock
from repro_torch.serving.gateway.events import (AudioChunk, BargeIn, Hangup,
                                                HandoffRequest, SessionClosed,
                                                SessionEvent, SpeechEnd,
                                                SpeechStart, ToolCallResult,
                                                ToolCallStart, TurnDone,
                                                TurnRequest, UserAudio)
from repro_torch.serving.metrics import Metrics, TurnRecord


@dataclass
class GatewayConfig:
    policy: str = "liveserve"            # liveserve | fcfs
    audio_per_token_s: float = 0.08      # playable audio per output token
    # Algorithm 1 per-round budget / prompt tokens per granted round.
    # Retuned for the fused data plane (DESIGN.md §11): a 16-token
    # prefill chunk costs one launch, not 16, so chunks are sized for
    # scheduling granularity alone (the pre-fused default was 4 only
    # because a chunk cost C sequential launches).
    round_token_budget: int = 16
    prefill_chunk: int = 16
    # hard generation cap beyond the playback frontier (seconds of client
    # buffer). None = rely on the scheduler's pacing class alone; set it
    # to enforce the cap even under the KV-pressure pacing override.
    frontier_cap_s: Optional[float] = None
    sched: Optional[SchedulerConfig] = None
    idle_sleep_s: float = 0.05           # scaled-clock wait when idle
    # transfer chunks drained per idle pass (run_round drains its own
    # per-round budget; this keeps preloads moving when nothing decodes)
    idle_transfer_chunks: int = 2


@dataclass
class PendingTurn:
    """A TurnRequest the scheduler has not yet admitted to a slot."""
    session_id: str
    prompt: np.ndarray
    max_new_tokens: int
    request: Request


@dataclass
class GatewaySession:
    session_id: str
    outbox: asyncio.Queue
    turn_no: int = -1                    # last TurnRequest's index
    closed: bool = False


class SessionHandle:
    """Client side of one duplex session (in-process transport)."""

    def __init__(self, gateway: "RealtimeGateway", gs: GatewaySession):
        self._gw = gateway
        self._gs = gs
        self.session_id = gs.session_id

    async def send(self, ev: SessionEvent) -> None:
        ev.t = self._gw.clock.now()
        await self._gw._inbox.put(ev)

    async def recv(self) -> SessionEvent:
        return await self._gs.outbox.get()


def build_scheduler(policy: str, monitor, kv_occupancy, *, chunk: int,
                    decode_chunk: int = 1,
                    sc: Optional[SchedulerConfig] = None):
    """One engine's round scheduler — shared by the asyncio gateway,
    the replay twin, and the fleet gateways (each replica gets its own
    scheduler over its own monitor/KV pressure). ``decode_chunk`` > 1
    turns decode grants into "up to K draft tokens" budgets for the
    speculative plane (DESIGN.md §16)."""
    if policy == "liveserve":
        return UrgencyScheduler(sc or SchedulerConfig(), monitor,
                                stage="thinker",
                                kv_occupancy=kv_occupancy,
                                prefill_chunk=chunk,
                                decode_chunk=decode_chunk)
    return FCFSScheduler(monitor, stage="thinker", prefill_chunk=chunk,
                         decode_chunk=decode_chunk)


def frame_token_tick(monitor, rec, sid: str, now: float) -> None:
    """Per-emitted-token frame accounting for periodic (full-duplex)
    sessions — shared by both gateway twins so the deadline-miss
    counters cannot drift between the live loop and the replay. The
    deadline walks one period per token from the turn request (hard
    periodic-task semantics: falling behind accumulates misses, it does
    not re-anchor the schedule)."""
    v = monitor.view(sid)
    if v is None or v.frame_deadline is None:
        return
    if now > v.frame_deadline + 1e-9:
        rec.deadline_misses += 1
    rec.frames += 1
    v.frame_deadline += v.frame_period_s


def record_admitted_turn(rec, r: Request) -> None:
    """Copy the admission-time reload accounting from the Request onto
    the TurnRecord — the one coupling between the engine's turn stats
    and the serving metrics, shared by both gateway twins so the
    sim/real differential cannot drift field-by-field."""
    rec.reload_stall_s = r.reload_stall_s
    rec.reload_off_path_s = r.reload_off_path_s
    rec.prefix_hit_tokens = r.prefix_hit_tokens
    # prompt_len counts only the tokens left to prefill after a prefix
    # attach; the record keeps the client-visible total
    rec.prompt_tokens = r.prompt_len + r.prefix_hit_tokens


def control_round(eng, scheduler, pending, *, token_budget: int,
                  frontier_cap_s: Optional[float], record_admit):
    """One Algorithm-1 control round over a paged engine — the single
    source of truth shared by the asyncio ``RealtimeGateway`` and the
    deterministic ``ReplayGateway`` (gateway/replay.py), so the replay
    twin used by the differential harness cannot drift from the real
    serving loop. Builds the candidate set (live slots minus decode
    slots past the frontier cap, plus queued turns), asks the scheduler
    for the round's admission, binds admitted pending turns to slots
    (requeueing on a saturated-pool ``OutOfPages``), and returns
    ``(decision, chunks, admitted)``; ``decision`` is None when nothing
    was ready. ``record_admit(sid, request)`` fires per admitted turn.
    """
    now = eng.clock.now()
    ready: List[Request] = []
    owner: Dict[int, tuple] = {}

    def over_frontier(sid: str) -> bool:
        if frontier_cap_s is None:
            return False
        buf = eng.monitor.playback_buffer_s(sid)
        return buf is not None and buf > frontier_cap_s

    for i, s in eng.slot_state.items():
        if s is None or not s.request.is_live():
            continue
        if s.request.generated >= s.request.max_new_tokens:
            continue
        if s.request.phase == Phase.DECODE \
                and over_frontier(s.session_id):
            continue                         # hard frontier cap (§4)
        s.request.slot_bound = True
        ready.append(s.request)
        owner[s.request.req_id] = ("slot", i)
    for sid, p in pending.items():
        p.request.slot_bound = False
        ready.append(p.request)
        owner[p.request.req_id] = ("pending", sid)
    if not ready:
        return None, {}, False
    budget = RoundBudget(
        token_budget=token_budget,
        free_kv_blocks=eng.kv.free_blocks
        + eng.kv.reclaimable_blocks(now),
        max_batch=eng.slots, block_size=eng.page_size,
        free_slots=sum(1 for s in eng.slot_state.values() if s is None))
    decision = scheduler.schedule(ready, budget, now)
    chunks: Dict[int, int] = {}
    admitted = False
    for r in decision.batch:
        kind, key = owner[r.req_id]
        if kind == "slot":
            chunks[key] = decision.chunks[r.req_id]
            continue
        if eng.free_slot() is None:
            continue                         # all slots busy; stay queued
        p = pending.pop(key)
        try:
            eng.submit_turn(key, p.prompt, p.max_new_tokens,
                            request=r)       # reload path runs here
        except OutOfPages:
            # saturated pool: the session's offloaded pages cannot be
            # reloaded yet (everything else pinned/protected). Keep the
            # turn queued — pressure drains as turns finish or barge-ins
            # trim
            pending[key] = p
            continue
        record_admit(key, r)
        admitted = True                      # prefill starts next round
    return decision, chunks, admitted


class RealtimeGateway:
    def __init__(self, engine, *, cfg: Optional[GatewayConfig] = None):
        self.engine = engine
        self.cfg = cfg or GatewayConfig()
        self.clock = engine.clock
        self._init_common()
        self.scheduler = build_scheduler(
            self.cfg.policy, engine.monitor, engine.kv.occupancy,
            chunk=self.sched_chunk(), decode_chunk=self.decode_chunk(),
            sc=self.cfg.sched)

    def sched_chunk(self) -> int:
        # a prefill chunk larger than the round budget can never be
        # admitted — Algorithm 1's head-of-line break would then hold it
        # (and everything behind it) forever
        return max(1, min(self.cfg.prefill_chunk,
                          self.cfg.round_token_budget))

    def decode_chunk(self) -> int:
        # pending token + the engine's draft budget, clamped to the
        # round budget for the same head-of-line reason as sched_chunk
        return max(1, min(1 + getattr(self.engine, "spec_decode", 0),
                          self.cfg.round_token_budget))

    def _init_common(self) -> None:
        assert hasattr(self.clock, "real_s"), \
            "gateway needs a ScaledWallClock-like clock on the engine " \
            "(sim time and wall time must be the same timeline)"
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._sessions: Dict[str, GatewaySession] = {}
        self._pending: Dict[str, PendingTurn] = {}
        self._recs: Dict[Tuple[str, int], TurnRecord] = {}
        self._metrics = Metrics()
        self._stopping = False
        self._force_stop = False
        self.rounds = 0
        # frontier telemetry: worst observed client buffer beyond the
        # configured cap at token-emission time (the §4 invariant)
        self.max_over_frontier_s = 0.0

    # engine indirection: the fleet gateway (serving/fleet) overrides
    # these two so every per-session path below runs against the
    # replica the router placed the session on
    def _eng(self, sid: str):
        return self.engine

    def _engines(self):
        return (self.engine,)

    # ------------------------------------------------------------ clients
    def connect(self, session_id: str) -> SessionHandle:
        assert session_id not in self._sessions, session_id
        gs = GatewaySession(session_id, asyncio.Queue())
        self._sessions[session_id] = gs
        return SessionHandle(self, gs)

    def stop(self, force: bool = False) -> None:
        """Finish in-flight work, then exit the serve loop. ``force``
        exits at the next idle point even with work still queued (the
        harness uses it when the load's deadline lapses)."""
        self._stopping = True
        self._force_stop = self._force_stop or force

    def metrics(self) -> Metrics:
        self._metrics.sim_end = self.clock.now()
        self._metrics.pages_shared = max(
            (getattr(e, "peak_shared_pages", 0) for e in self._engines()),
            default=0)
        self._metrics.kv_wire_bytes_saved = sum(
            e.transfer.stats.wire_bytes_saved for e in self._engines())
        for f in ("spec_drafted", "spec_accepted", "spec_rejected",
                  "spec_rounds"):
            setattr(self._metrics, f,
                    sum(getattr(e, f, 0) for e in self._engines()))
        return self._metrics

    # ------------------------------------------------------------ records
    def _rec(self, sid: str) -> TurnRecord:
        gs = self._sessions[sid]
        key = (sid, gs.turn_no)
        rec = self._recs.get(key)
        if rec is None:
            rec = TurnRecord(session_id=sid, turn_index=gs.turn_no)
            self._recs[key] = rec
            self._metrics.turns.append(rec)
        return rec

    # ------------------------------------------------------------ events
    def _handle(self, ev: SessionEvent) -> None:
        sid = ev.session_id
        eng = self._eng(sid)
        if isinstance(ev, SpeechStart):
            # fires the §5.2 speech-time preload while the user talks
            eng.user_speech_start(sid, expected_dur_s=ev.expected_dur_s)
        elif isinstance(ev, UserAudio):
            pass    # audio payload is transport metadata; the VAD
            #         events (SpeechStart/End) carry the policy signal
        elif isinstance(ev, SpeechEnd):
            eng.monitor.on_speech_end(sid)
        elif isinstance(ev, TurnRequest):
            self._on_turn_request(ev)
        elif isinstance(ev, BargeIn):
            self._on_barge_in(ev)
        elif isinstance(ev, ToolCallStart):
            self._metrics.tool_pauses += 1
            eng.tool_call_start(sid, ev.expected_latency_s)
        elif isinstance(ev, ToolCallResult):
            eng.tool_call_result(sid, ev.resume_gap_s)
        elif isinstance(ev, HandoffRequest):
            self._on_handoff(ev)
        elif isinstance(ev, Hangup):
            self._on_hangup(sid)

    def _on_turn_request(self, ev: TurnRequest) -> None:
        sid = ev.session_id
        gs = self._sessions[sid]
        gs.turn_no += 1
        now = self.clock.now()
        sess = self._eng(sid).sessions.get(sid)
        req = Request(session_id=sid, stage="thinker",
                      turn_index=gs.turn_no, arrival_time=now,
                      prompt_len=int(len(ev.prompt)),
                      context_len=sess.kv_len if sess else 0,
                      max_new_tokens=ev.max_new_tokens,
                      audio_per_token_s=self.cfg.audio_per_token_s)
        self._pending[sid] = PendingTurn(sid, np.asarray(ev.prompt,
                                                         np.int32),
                                         ev.max_new_tokens, req)
        rec = self._rec(sid)
        rec.speech_end = now
        if ev.frame_period_s > 0.0:
            self._eng(sid).monitor.on_frame_turn(sid, ev.frame_period_s)
        rec.tool_resumed = ev.tool_resume

    def _on_handoff(self, ev: HandoffRequest) -> None:
        """Single-engine gateway: there is nowhere to move the session;
        acknowledge-and-stay (the fleet gateway overrides this with a
        targeted migration)."""

    def _slot_of(self, sid: str) -> Optional[int]:
        for i, s in self._eng(sid).slot_state.items():
            if s is not None and s.session_id == sid:
                return i
        return None

    def _on_barge_in(self, ev: BargeIn) -> None:
        sid = ev.session_id
        eng = self._eng(sid)
        now = self.clock.now()
        slot = self._slot_of(sid)
        gs = self._sessions[sid]
        rec = self._recs.get((sid, gs.turn_no))
        view = eng.monitor.view(sid)
        drained = rec is not None and rec.completed and (
            view is None or view.playback.buffer_s(now) <= 0)
        if drained and slot is None and sid not in self._pending:
            # mirror the simulator: a barge-in after playback fully
            # drained is a pure no-op — it must not mark the session
            # interrupted (that would skip the reply-gap EMA and keep
            # its idle KV immediate-reuse-protected)
            return
        pend = self._pending.pop(sid, None)
        if pend is not None:
            pend.request.state = RequestState.ABORTED
        if rec is not None and not drained:
            # during decode or playback the barge cuts the turn
            rec.barged = True
            heard = view.playback.consumed_s(now) if view else 0.0
            rec.audio_heard_s = heard
            heard_tokens = int(heard / self.cfg.audio_per_token_s)
            rec.talker_wasted = max(0, rec.talker_generated - heard_tokens)
            rec.finish_time = now
        # aborts the live turn (keeping committed pages) and fires the
        # barge-in preload trigger; no-op on the slot if none is live
        eng.barge_in(sid, expected_dur_s=ev.expected_dur_s)
        if slot is None:
            eng.monitor.on_barge_in(sid)     # slot path already did it
        if slot is not None or pend is not None:
            gs.outbox.put_nowait(TurnDone(
                sid, t=now, turn_index=gs.turn_no, aborted=True,
                generated=rec.talker_generated if rec else 0))

    def _on_hangup(self, sid: str) -> None:
        eng = self._eng(sid)
        gs = self._sessions[sid]
        if self._slot_of(sid) is not None:
            eng.abort(sid)
        self._pending.pop(sid, None)
        if sid in eng.sessions and not eng.sessions[sid].ended:
            eng.end_session(sid)
        gs.closed = True
        self._metrics.completed_sessions += 1
        gs.outbox.put_nowait(SessionClosed(sid, t=self.clock.now()))

    # ------------------------------------------------------------ rounds
    def _record_admit(self, sid: str, r: Request) -> None:
        record_admitted_turn(self._rec(sid), r)

    def _round(self) -> bool:
        """One scheduler-driven round. Returns True if any work ran."""
        eng = self.engine
        decision, chunks, admitted = control_round(
            eng, self.scheduler, self._pending,
            token_budget=self.cfg.round_token_budget,
            frontier_cap_s=self.cfg.frontier_cap_s,
            record_admit=self._record_admit)
        if decision is None:
            return False
        self.last_decision = decision
        if not chunks:
            return admitted
        sids = {i: eng.slot_state[i].session_id for i in chunks}
        events = eng.run_round(chunks)
        self.rounds += 1
        self._dispatch(events, sids)
        return True

    def _dispatch(self, events: Dict[int, List[tuple]],
                  sids: Dict[int, str]) -> None:
        apt = self.cfg.audio_per_token_s
        for slot, evs in events.items():
            sid = sids[slot]
            eng = self._eng(sid)
            gs = self._sessions[sid]
            rec = self._rec(sid)
            for kind, val in evs:
                now = self.clock.now()
                if kind == "token":
                    if rec.ttfp is None:
                        rec.ttfp = now - rec.speech_end
                        rec.text_ttft = rec.ttfp
                    frame_token_tick(eng.monitor, rec, sid, now)
                    eng.monitor.on_audio(sid, apt)
                    rec.audio_delivered_s += apt
                    rec.talker_generated += 1
                    if self.cfg.frontier_cap_s is not None:
                        buf = eng.monitor.playback_buffer_s(sid) or 0.0
                        self.max_over_frontier_s = max(
                            self.max_over_frontier_s,
                            buf - self.cfg.frontier_cap_s)
                    gs.outbox.put_nowait(AudioChunk(
                        sid, t=now, turn_index=gs.turn_no, dur_s=apt,
                        token=val))
                elif kind == "finished":
                    v = eng.monitor.view(sid)
                    rec.max_gap_s = (v.playback.max_gap_s
                                     if v.playback.gap_s else 0.0)
                    rec.n_gaps = v.playback.n_gaps
                    rec.gen_span_s = now - rec.speech_end - (rec.ttfp or 0.0)
                    rec.completed = True
                    rec.finish_time = now
                    gs.outbox.put_nowait(TurnDone(
                        sid, t=now, turn_index=gs.turn_no, aborted=False,
                        generated=val))

    # ------------------------------------------------------------ serve
    def _drain(self) -> int:
        n = 0
        while True:
            try:
                ev = self._inbox.get_nowait()
            except asyncio.QueueEmpty:
                break
            self._handle(ev)
            n += 1
        return n

    def _live_work(self) -> bool:
        if self._pending:
            return True
        return any(s is not None and s.request.is_live()
                   for eng in self._engines()
                   for s in eng.slot_state.values())

    def _pump(self) -> None:
        """Per-iteration control-plane work beyond event handling; the
        fleet gateway advances its migration plans here (atomic with
        rounds under the single-threaded asyncio contract)."""

    def _idle_drain(self) -> None:
        if self.cfg.idle_transfer_chunks <= 0:   # budget 0 = drains off
            return
        for eng in self._engines():
            eng.drain_transfers(self.cfg.idle_transfer_chunks)

    def _hold_wake(self) -> Optional[float]:
        ld = getattr(self, "last_decision", None)
        if not ld:
            return None
        return self.scheduler.hold_wake_s(ld, self.clock.now())

    async def run(self) -> None:
        """Serve until ``stop()`` is called and in-flight work drains."""
        while True:
            self._drain()
            self._pump()
            if self._round():
                await asyncio.sleep(0)       # let client tasks react
                continue
            if self._force_stop:
                return
            if self._stopping and self._inbox.empty() \
                    and not self._live_work():
                return
            # idle: nothing decodes this instant, but queued transfer
            # chunks (a speech-time preload, a copy-then-free offload, a
            # migrate-out drain) still progress — this is exactly the
            # window the paper hides reload work in (DESIGN.md §10)
            self._idle_drain()
            wake = self.cfg.idle_sleep_s
            held = self._hold_wake()
            if held is not None:
                wake = min(wake, held)
            try:
                ev = await asyncio.wait_for(
                    self._inbox.get(), timeout=self.clock.real_s(wake))
                self._handle(ev)
            except asyncio.TimeoutError:
                pass
