"""Deterministic virtual-time gateway replay (DESIGN.md §4, §9).

The asyncio ``RealtimeGateway`` runs the control plane against a scaled
*wall* clock — great for end-to-end realism, useless for property-based
differential testing, where an example must be bit-reproducible and
fast. This module replays the same ``serving/workload.py`` traces
through the same ``PagedRealtimeEngine`` round API
(``submit_turn``/``run_round``/``barge_in``/``end_session``) and the
same ``core/scheduler.py`` Algorithm 1, but on a virtual clock the
replay loop owns: rounds cost a fixed ``round_dt`` of virtual seconds,
idle time jumps straight to the next client event, and the client state
machine (speak → turn request → listen → barge/think → speak) is the
synchronous mirror of ``gateway/client.py``.

Scheduling-visible behavior — which turns complete in which order,
what the playback-frontier cap holds, which sessions the KV policy
evicts — is therefore a pure function of (workload seed, engine
geometry), directly comparable against ``serving/simulator.py`` on the
same trace. That comparison is the differential harness in
``tests/test_torch_gateway.py``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import (FCFSScheduler, SchedulerConfig,
                                        UrgencyScheduler)
from repro_torch.core.session import Request, RequestState
from repro_torch.serving.engine import RoundLimitExceeded
from repro_torch.serving.gateway.gateway import (control_round,
                                                 frame_token_tick,
                                                 record_admitted_turn)
from repro_torch.serving.metrics import Metrics, TurnRecord
from repro_torch.serving.workload import (TOOL_RESUME_GAP_S, WorkloadConfig,
                                          family_prefix, generate)


class ReplayClock:
    """Virtual time owned by the replay loop. The engine's per-round
    ``tick()`` is free; the loop charges ``round_dt`` per executed round
    and jumps over idle gaps."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def tick(self, dt: float = 0.0) -> None:
        self.t += dt

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, t)


@dataclass
class ReplayConfig:
    policy: str = "liveserve"            # liveserve | fcfs
    audio_per_token_s: float = 0.25
    round_token_budget: int = 4
    prefill_chunk: int = 2
    frontier_cap_s: Optional[float] = 3.0
    round_dt: float = 0.02               # virtual cost of one round
    max_turns: int = 2                   # trace clamps (as client.py)
    max_prompt: int = 6
    max_response: int = 6
    sched: Optional[SchedulerConfig] = None


@dataclass
class _Pending:
    session_id: str
    prompt: np.ndarray
    max_new_tokens: int
    request: Request


class ReplayGateway:
    """Synchronous, virtually-clocked twin of ``RealtimeGateway``."""

    def __init__(self, engine, workload: WorkloadConfig,
                 cfg: Optional[ReplayConfig] = None, *, seed: int = 0):
        self.eng = engine
        self.cfg = cfg or ReplayConfig()
        self.clock = engine.clock
        assert isinstance(self.clock, ReplayClock), \
            "build the engine on a ReplayClock (the replay loop owns time)"
        sc = self.cfg.sched or SchedulerConfig()
        chunk = max(1, min(self.cfg.prefill_chunk,
                           self.cfg.round_token_budget))
        dchunk = max(1, min(1 + getattr(engine, "spec_decode", 0),
                            self.cfg.round_token_budget))
        if self.cfg.policy == "liveserve":
            self.scheduler = UrgencyScheduler(
                sc, engine.monitor, stage="thinker",
                kv_occupancy=engine.kv.occupancy, prefill_chunk=chunk,
                decode_chunk=dchunk)
        else:
            self.scheduler = FCFSScheduler(
                engine.monitor, stage="thinker", prefill_chunk=chunk,
                decode_chunk=dchunk)
        self.metrics = Metrics()
        self._recs: Dict[Tuple[str, int], TurnRecord] = {}
        self._pending: Dict[str, _Pending] = {}
        self._turn_no: Dict[str, int] = {}
        self._events: List[tuple] = []       # (t, seq, fn)
        self._seq = itertools.count()
        self.rounds = 0
        self.max_over_frontier_s = 0.0
        self._admit_trace(workload, seed)

    # ----------------------------------------------------- fleet hooks
    # The fleet replay twin (serving/fleet/replay.py) overrides these so
    # every per-session path below runs against the replica its router
    # placed the session on — the same seam RealtimeGateway exposes.
    def _eng(self, sid: str):
        return self.eng

    def _engines(self):
        return (self.eng,)

    def _pump(self) -> None:
        """Fleet migration plans advance here, between event delivery
        and the round — the virtual-time mirror of the asyncio
        gateway's ``_pump``."""

    def _idle_transfer(self) -> bool:
        did = False
        for e in self._engines():
            did = bool(e.drain_transfers(1)) or did
        return did

    # ------------------------------------------------------------ trace
    def _admit_trace(self, workload: WorkloadConfig, seed: int) -> None:
        """Clamp the trace exactly like ``gateway/client.py`` (one rng
        draw per turn, stream keyed [seed, session-index]) so the same
        (workload, seed) yields identical prompts here and in the
        asyncio gateway. All draws happen up front: replay scheduling
        order can never perturb them."""
        self._trace = generate(workload)
        self._by_sid = {s.session_id: s for s in self._trace}
        self._turns: Dict[str, list] = {}
        for i, s in enumerate(self._trace):
            rng = np.random.default_rng([seed, i])
            fam = (family_prefix(workload, s.family,
                                 self.eng.cfg.vocab_size, seed)
                   if s.family >= 0 and workload.family_prefix_len > 0
                   else None)
            lst = []
            for turn in s.turns[:self.cfg.max_turns]:
                prompt = rng.integers(
                    0, self.eng.cfg.vocab_size,
                    size=max(1, min(turn.prompt_len, self.cfg.max_prompt)))
                if fam is not None and turn.index == 0:
                    # the shared system prompt rides UNCLAMPED ahead of
                    # the per-turn draw — same splice as client.py
                    prompt = np.concatenate([fam, prompt])
                n_tokens = max(2, min(turn.response_tokens,
                                      self.cfg.max_response))
                speech_dur = max(0.05, turn.speech_end - turn.speech_start)
                cut_s = None
                if turn.barge_in:
                    apt = self.cfg.audio_per_token_s
                    frac = turn.barge_cut_s / max(
                        1e-9, turn.response_tokens * apt)
                    cut_s = max(apt, min(frac, 0.9) * n_tokens * apt)
                lst.append((np.asarray(prompt, np.int32), n_tokens,
                            speech_dur, cut_s, turn))
            self._turns[s.session_id] = lst
            self._push(s.arrival_time, self._speech_start, s, 0)

    def _push(self, t: float, fn, *args) -> None:
        heapq.heappush(self._events, (t, next(self._seq), fn, args))

    def _rec(self, sid: str) -> TurnRecord:
        key = (sid, self._turn_no[sid])
        rec = self._recs.get(key)
        if rec is None:
            rec = TurnRecord(session_id=sid, turn_index=key[1])
            self._recs[key] = rec
            self.metrics.turns.append(rec)
        return rec

    # ----------------------------------------------------- client events
    def _clamped_turn(self, s, ti: int):
        return self._turns[s.session_id][ti]

    def _handoff_request(self, sid: str, target: int) -> None:
        """Single-engine replay: nowhere to move the session —
        acknowledge-and-stay (the fleet twin overrides this with a
        targeted migration, mirroring the fleet gateway)."""

    def _speech_start(self, s, ti: int) -> None:
        sid = s.session_id
        _, _, speech_dur, _, turn = self._clamped_turn(s, ti)
        if turn.handoff:
            self._handoff_request(sid, turn.handoff_target)
        if turn.frame_period_tokens > 0.0:
            # full duplex: the request fires at speech onset, with no
            # duration estimate and no SpeechEnd gate (client.py mirror)
            self._eng(sid).user_speech_start(sid)
            self._push(self.clock.now(), self._turn_request, s, ti)
        else:
            self._eng(sid).user_speech_start(sid,
                                             expected_dur_s=speech_dur)
            self._push(self.clock.now() + speech_dur, self._turn_request,
                       s, ti)

    def _turn_request(self, s, ti: int, resume: bool = False) -> None:
        sid = s.session_id
        prompt, n_tokens, _, _, turn = self._clamped_turn(s, ti)
        eng = self._eng(sid)
        duplex = turn.frame_period_tokens > 0.0
        if not duplex and not resume:
            # the client sends SpeechEnd just before TurnRequest only on
            # the half-duplex speech path (no utterance gates a duplex
            # or tool-resume turn)
            eng.monitor.on_speech_end(sid)
        self._turn_no[sid] = ti
        now = self.clock.now()
        sess = eng.sessions.get(sid)
        req = Request(session_id=sid, stage="thinker", turn_index=ti,
                      arrival_time=now, prompt_len=int(len(prompt)),
                      context_len=sess.kv_len if sess else 0,
                      max_new_tokens=n_tokens,
                      audio_per_token_s=self.cfg.audio_per_token_s)
        self._pending[sid] = _Pending(sid, np.asarray(prompt, np.int32),
                                      n_tokens, req)
        rec = self._rec(sid)
        rec.speech_end = now
        if duplex:
            eng.monitor.on_frame_turn(
                sid, turn.frame_period_tokens * self.cfg.audio_per_token_s)
        rec.tool_resumed = resume

    def _barge(self, s, ti: int) -> None:
        """The trace's cut point (anchored post-TTFP, like client.py):
        interrupt playback, then the interrupting utterance becomes the
        next turn immediately."""
        sid = s.session_id
        eng = self._eng(sid)
        now = self.clock.now()
        rec = self._recs.get((sid, ti))
        view = eng.monitor.view(sid)
        slot = self._slot_of(sid)
        drained = rec is not None and rec.completed and (
            view is None or view.playback.buffer_s(now) <= 0)
        if not (drained and slot is None and sid not in self._pending):
            pend = self._pending.pop(sid, None)
            if pend is not None:
                pend.request.state = RequestState.ABORTED
            if rec is not None and not drained:
                rec.barged = True
                heard = view.playback.consumed_s(now) if view else 0.0
                rec.audio_heard_s = heard
                heard_tokens = int(heard / self.cfg.audio_per_token_s)
                rec.talker_wasted = max(0, rec.talker_generated
                                        - heard_tokens)
                rec.finish_time = now
            nturns = self._turns[sid]
            speech_dur = (nturns[ti + 1][2] if ti + 1 < len(nturns)
                          else None)
            eng.barge_in(sid, expected_dur_s=speech_dur)
            if slot is None:
                eng.monitor.on_barge_in(sid)
        self._next_or_hangup(s, ti, at=now)

    def _turn_done(self, s, ti: int) -> None:
        sid = s.session_id
        eng = self._eng(sid)
        now = self.clock.now()
        turn = self._clamped_turn(s, ti)[4]
        if turn.frame_period_tokens > 0.0:
            # full-duplex utterance closes with the turn (client.py
            # sends its SpeechEnd on TurnDone)
            eng.monitor.on_speech_end(sid)
        if turn.tool_call and ti + 1 < len(self._turns[sid]):
            self._tool_pause(s, ti)
            return
        v = eng.monitor.view(sid)
        drain = v.playback.buffer_s(now) if v else 0.0
        self._next_or_hangup(s, ti,
                             at=now + drain + (s.think_time_s or 0.0))

    def _tool_pause(self, s, ti: int) -> None:
        """The reply ended in a tool call: idle with hot KV for the
        tool's latency, then resume without a new utterance — the
        synchronous mirror of client.py's ToolCallStart/Result flow."""
        sid = s.session_id
        turn = self._clamped_turn(s, ti)[4]
        self.metrics.tool_pauses += 1
        self._eng(sid).tool_call_start(sid, turn.tool_latency_s)
        self._push(self.clock.now() + turn.tool_latency_s,
                   self._tool_result, s, ti)

    def _tool_result(self, s, ti: int) -> None:
        sid = s.session_id
        self._eng(sid).tool_call_result(sid, TOOL_RESUME_GAP_S)
        self._push(self.clock.now() + TOOL_RESUME_GAP_S,
                   self._turn_request, s, ti + 1, True)

    def _next_or_hangup(self, s, ti: int, *, at: float) -> None:
        nxt = ti + 1
        if nxt < len(self._turns[s.session_id]):
            self._push(at, self._speech_start, s, nxt)
        else:
            self._push(at, self._hangup, s)

    def _hangup(self, s) -> None:
        sid = s.session_id
        eng = self._eng(sid)
        if self._slot_of(sid) is not None:
            eng.abort(sid)
        self._pending.pop(sid, None)
        if sid in eng.sessions and not eng.sessions[sid].ended:
            eng.end_session(sid)
        self.metrics.completed_sessions += 1

    def _slot_of(self, sid: str) -> Optional[int]:
        for i, st in self._eng(sid).slot_state.items():
            if st is not None and st.session_id == sid:
                return i
        return None

    def _record_admit(self, sid: str, r: Request) -> None:
        record_admitted_turn(self._rec(sid), r)

    # ------------------------------------------------------------ rounds
    def _round(self) -> bool:
        """One scheduler round: the shared ``control_round`` body (the
        very same code the asyncio gateway runs — candidate set,
        frontier cap, OutOfPages requeue), executed synchronously."""
        eng = self.eng
        decision, chunks, admitted = control_round(
            eng, self.scheduler, self._pending,
            token_budget=self.cfg.round_token_budget,
            frontier_cap_s=self.cfg.frontier_cap_s,
            record_admit=self._record_admit)
        if decision is None:
            return False
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
            s = self._by_sid[sid]
            ti = self._turn_no[sid]
            rec = self._rec(sid)
            for kind, val in evs:
                now = self.clock.now()
                if kind == "token":
                    first = rec.ttfp is None
                    if first:
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
                    if first:
                        # the trace's barge cut anchors at first audio
                        cut_s = self._clamped_turn(s, ti)[3]
                        if cut_s is not None:
                            self._push(now + cut_s, self._barge, s, ti)
                elif kind == "finished":
                    v = eng.monitor.view(sid)
                    rec.max_gap_s = (v.playback.max_gap_s
                                     if v.playback.gap_s else 0.0)
                    rec.n_gaps = v.playback.n_gaps
                    rec.gen_span_s = now - rec.speech_end \
                        - (rec.ttfp or 0.0)
                    rec.completed = True
                    rec.finish_time = now
                    cut_s = self._clamped_turn(s, ti)[3]
                    if cut_s is None:
                        self._turn_done(s, ti)
                    # else: the scheduled barge advances the session

    # ------------------------------------------------------------ run
    def _live_work(self) -> bool:
        if self._pending:
            return True
        return any(st is not None and st.request.is_live()
                   and st.request.generated < st.request.max_new_tokens
                   for e in self._engines()
                   for st in e.slot_state.values())

    def run(self, *, max_rounds: int = 200_000,
            check_every_round=None) -> Metrics:
        """Drive the full trace to completion. ``check_every_round``
        (e.g. ``engine.check_invariants``) runs after every executed
        round. Raises ``RoundLimitExceeded`` — never swallows it — if
        the schedule live-locks."""
        idle = 0
        while self._events or self._live_work():
            while self._events and self._events[0][0] <= self.clock.now():
                _, _, fn, args = heapq.heappop(self._events)
                fn(*args)
            self._pump()
            if self._round():
                self.clock.tick(self.cfg.round_dt)
                idle = 0
                if check_every_round is not None:
                    check_every_round()
                if self.rounds > max_rounds:
                    raise RoundLimitExceeded(
                        f"replay still live after {max_rounds} rounds")
                continue
            # idle gap: queued transfer chunks drain before time jumps
            # to the next client event — the deterministic mirror of
            # the asyncio gateway's idle-loop drain, so a speech-time
            # preload lands during the (virtual) utterance
            if self._idle_transfer():
                self.clock.tick(self.cfg.round_dt)
                if check_every_round is not None:
                    check_every_round()
                continue
            if self._events:
                self.clock.advance_to(self._events[0][0])
                continue
            if self._live_work():
                # paced/held work with no client events: playback must
                # drain (or pressure lift) before anything schedules
                self.clock.tick(max(self.cfg.round_dt, 0.05))
                idle += 1
                if idle > max_rounds:
                    raise RoundLimitExceeded(
                        "replay wedged: live work that never reschedules")
                continue
        self.metrics.sim_end = self.clock.now()
        self.metrics.pages_shared = max(
            (getattr(e, "peak_shared_pages", 0) for e in self._engines()),
            default=0)
        self.metrics.kv_wire_bytes_saved = sum(
            e.transfer.stats.wire_bytes_saved for e in self._engines())
        for f in ("spec_drafted", "spec_accepted", "spec_rejected",
                  "spec_rounds"):
            setattr(self.metrics, f,
                    sum(getattr(e, f, 0) for e in self._engines()))
        return self.metrics


def run_replay(engine_factory, workload: WorkloadConfig,
               cfg: Optional[ReplayConfig] = None, *, seed: int = 0,
               check_invariants: bool = True):
    """Build engine on a ReplayClock via ``engine_factory(clock)``,
    replay the workload, return (metrics, ReplayGateway)."""
    clock = ReplayClock()
    eng = engine_factory(clock)
    gw = ReplayGateway(eng, workload, cfg, seed=seed)
    gw.run(check_every_round=eng.check_invariants
           if check_invariants else None)
    return gw.metrics, gw
