"""Runtime monitor — the interaction plane (paper §3).

Turns client-side signals (playback progress, speech activity, barge-in)
into a compact per-session view read by the scheduler and KV manager.
All fields are optional-by-design: policies that find missing telemetry
fall back to substrate behavior (fail-closed operation, §6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

REPLY_GAP_EMA = 0.3              # weight of newest observation


@dataclass
class PlaybackState:
    """Client playback as a piecewise timeline.

    ``play_end`` is the wall-clock instant buffered audio runs out;
    appending audio at time t extends it (opening a gap if t > play_end).

    Robust to degenerate client reports: a zero/negative-duration chunk
    never marks playback as started (an empty packet is not first
    audio), out-of-order appends (t below an earlier append's t) queue
    behind the existing buffer without rewinding the timeline, and
    ``play_end`` is monotone non-decreasing throughout.
    """
    started: bool = False
    start_time: float = 0.0
    appended_s: float = 0.0          # total audio delivered to the client
    play_end: float = 0.0            # when the buffer drains
    gap_s: float = 0.0               # cumulative stall time
    max_gap_s: float = 0.0
    n_gaps: int = 0
    complete: bool = False           # server finished generating the reply

    def append(self, now: float, dur_s: float) -> None:
        if dur_s <= 0.0 and not self.started:
            return                   # empty chunk cannot start playback
        if not self.started:
            self.started = True
            self.start_time = now
            self.play_end = now
        elif now > self.play_end:
            gap = now - self.play_end
            self.gap_s += gap
            self.max_gap_s = max(self.max_gap_s, gap)
            self.n_gaps += 1
            self.play_end = now
        self.appended_s += max(0.0, dur_s)
        self.play_end += max(0.0, dur_s)

    def buffer_s(self, now: float) -> float:
        """Playable audio waiting at the client (the P_i^s of audio stages)."""
        if not self.started:
            return 0.0
        return max(0.0, self.play_end - now)

    def consumed_s(self, now: float) -> float:
        """Audio the client has heard by ``now``; clamped non-negative so
        an out-of-order (stale-timestamped) query after a gap cannot
        report negative consumption."""
        if not self.started:
            return 0.0
        return max(0.0, self.appended_s - self.buffer_s(now))


@dataclass
class SessionView:
    """What the monitor exposes to engine policies."""
    session_id: str
    turn_index: int = 0
    playback: PlaybackState = field(default_factory=PlaybackState)
    speaking: bool = False
    speech_start_time: Optional[float] = None
    barge_in: bool = False           # interruption observed this response
    playback_end_estimate: Optional[float] = None
    reply_gap_ema: Optional[float] = None   # user think-time estimate (s)
    last_playback_end: Optional[float] = None
    expected_speech_end: Optional[float] = None
    # full-duplex frame cadence: a periodic-frame session's per-frame
    # deadline walks forward one period per emitted token. The period is
    # sticky across turns (it marks the session as duplex for preload
    # admission); the deadline only lives while a response streams.
    frame_period_s: float = 0.0
    frame_deadline: Optional[float] = None
    # mid-turn tool pause: the wall-clock instant the external tool is
    # expected to return — Eq. 4 next-use reads this instead of the
    # reply-gap EMA while it is in the future.
    tool_call_until: Optional[float] = None
    # physical KV placement (reported by the paged engine's data plane)
    resident_pages: int = 0
    offloaded_pages: int = 0


class RuntimeMonitor:
    """Tracks live session state; the single source the policies read."""

    def __init__(self, clock, *, workload_reply_gap_prior: float = 2.0):
        self.clock = clock
        self.sessions: Dict[str, SessionView] = {}
        self.reply_gap_prior = workload_reply_gap_prior

    # ----------------------------------------------------------- events
    def register(self, session_id: str) -> SessionView:
        view = self.sessions.get(session_id)
        if view is None:
            view = SessionView(session_id=session_id)
            self.sessions[session_id] = view
        return view

    def on_turn_start(self, session_id: str, turn_index: int) -> None:
        v = self.register(session_id)
        v.turn_index = turn_index
        v.barge_in = False
        v.playback = PlaybackState()
        # a turn can start without a SpeechEnd (full duplex, tool-call
        # resume): clear the previous utterance's state here so Eq. 4
        # next-use and the preload window never read last turn's
        # estimate as if it were current. frame_deadline stays — it was
        # armed by THIS turn's request (on_frame_turn) and anchors the
        # miss accounting at frame arrival, queueing delay included.
        v.speaking = False
        v.expected_speech_end = None
        v.tool_call_until = None

    def on_audio(self, session_id: str, dur_s: float) -> None:
        v = self.register(session_id)
        v.playback.append(self.clock.now(), dur_s)

    def on_response_complete(self, session_id: str) -> None:
        v = self.register(session_id)
        v.playback.complete = True
        v.last_playback_end = max(v.playback.play_end, self.clock.now())
        v.frame_deadline = None

    def on_speech_start(self, session_id: str,
                        expected_dur_s: Optional[float] = None) -> None:
        now = self.clock.now()
        v = self.register(session_id)
        v.speaking = True
        v.speech_start_time = now
        v.expected_speech_end = (now + expected_dur_s
                                 if expected_dur_s else None)
        # update think-time EMA: playback end -> speech start
        if v.last_playback_end is not None and not v.barge_in:
            gap = max(0.0, now - v.last_playback_end)
            if v.reply_gap_ema is None:
                v.reply_gap_ema = gap
            else:
                v.reply_gap_ema = ((1 - REPLY_GAP_EMA) * v.reply_gap_ema
                                   + REPLY_GAP_EMA * gap)

    def on_speech_end(self, session_id: str) -> None:
        v = self.register(session_id)
        v.speaking = False

    def on_barge_in(self, session_id: str) -> None:
        v = self.register(session_id)
        v.barge_in = True
        v.speaking = True
        v.speech_start_time = self.clock.now()
        v.playback.complete = True
        v.last_playback_end = self.clock.now()
        v.frame_deadline = None

    def on_frame_turn(self, session_id: str, frame_period_s: float) -> None:
        """A periodic-frame (full-duplex) turn was requested: arm the
        frame clock. The first frame is due one period from now; every
        emitted token advances the deadline by one period."""
        v = self.register(session_id)
        v.frame_period_s = frame_period_s
        v.frame_deadline = self.clock.now() + frame_period_s

    def on_tool_call_start(self, session_id: str,
                           expected_latency_s: float) -> None:
        """The turn ended in a tool call: the session idles with hot KV
        until roughly now + expected_latency_s. Not a speech event — the
        reply-gap EMA must not learn tool latencies as think time."""
        v = self.register(session_id)
        v.tool_call_until = self.clock.now() + max(0.0, expected_latency_s)
        v.speaking = False
        v.expected_speech_end = None

    def on_tool_call_result(self, session_id: str,
                            resume_gap_s: float = 0.0) -> None:
        """The tool returned: the resume turn arrives in ~resume_gap_s.
        Opens a preload window of that width (expected_speech_end) so an
        evicted session's reload hides in the gap, again without
        touching the speech state or the reply-gap EMA."""
        v = self.register(session_id)
        v.tool_call_until = None
        v.expected_speech_end = self.clock.now() + max(0.0, resume_gap_s)

    def on_page_movement(self, session_id: str, *, resident: int,
                         offloaded: int) -> None:
        """Data-plane report: where a session's KV pages physically live
        (HBM-resident vs DRAM-offloaded). Fed by the paged engine after
        every prefill/evict/reload/trim so dashboards and policies can
        read real placement instead of accounting estimates."""
        v = self.register(session_id)
        v.resident_pages = resident
        v.offloaded_pages = offloaded

    def forget(self, session_id: str) -> Optional[SessionView]:
        """Drop (and return) a session's view — the session left this
        monitor's engine (migrated away or fully released)."""
        return self.sessions.pop(session_id, None)

    def adopt(self, session_id: str, view: SessionView) -> None:
        """Install a view transplanted from another engine's monitor so
        interaction state (reply-gap EMA, speaking flag, expected speech
        end) survives a cross-replica migration — Eq. 4 and the preload
        window keep working on the destination without a cold start."""
        assert session_id not in self.sessions, session_id
        self.sessions[session_id] = view

    # ----------------------------------------------------------- queries
    def view(self, session_id: str) -> Optional[SessionView]:
        return self.sessions.get(session_id)

    def playback_buffer_s(self, session_id: str) -> Optional[float]:
        v = self.sessions.get(session_id)
        if v is None:
            return None
        return v.playback.buffer_s(self.clock.now())

    def remaining_playback_s(self, session_id: str) -> float:
        """T_play of Eq. 4 — audio still to be heard (buffered only; the
        paper's fallback uses progress counters when generation is live)."""
        v = self.sessions.get(session_id)
        if v is None:
            return 0.0
        return v.playback.buffer_s(self.clock.now())

    def reply_gap_s(self, session_id: str) -> float:
        """T_reply of Eq. 4 — per-session EMA, workload prior fallback."""
        v = self.sessions.get(session_id)
        if v is None or v.reply_gap_ema is None:
            return self.reply_gap_prior
        return v.reply_gap_ema

    def immediate_reuse(self, session_id: str) -> bool:
        v = self.sessions.get(session_id)
        return bool(v and (v.speaking or v.barge_in))

    def page_counts(self, session_id: str):
        """(resident, offloaded) physical page counts, (0, 0) unknown."""
        v = self.sessions.get(session_id)
        if v is None:
            return 0, 0
        return v.resident_pages, v.offloaded_pages
