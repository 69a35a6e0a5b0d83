"""Typed duplex event protocol between in-process clients and the
realtime gateway (DESIGN.md §4).

Client -> gateway (interaction signals, paper §3):
  UserAudio    raw mic audio reaching the gateway (metadata only here —
               duration, not samples; keeps the VAD/playback bookkeeping
               honest without shipping waveforms through the test rig)
  SpeechStart  VAD speech onset; fires the §5.2 speech-time KV preload
  SpeechEnd    utterance complete (ASR/encode follows)
  TurnRequest  the encoded utterance reaches the LLM stage: token
               prompt + response budget. Admission from here on is the
               scheduler's call, not the transport's.
  BargeIn      user interrupts playback: abort the in-flight turn
  ToolCallStart   the turn's reply ended in a tool invocation: the
               session idles with hot KV while the external tool runs
               (KV gains tool-pause protection with its own TTL; Eq. 4
               next-use becomes the tool's expected return)
  ToolCallResult  the tool returned; the resume turn follows in
               ``resume_gap_s`` — an evicted session's reload hides in
               that gap (resume-without-reprefill)
  HandoffRequest  transfer the session's committed context to a
               different model config/replica (rides the fleet MIGRATE
               machinery; single-replica gateways acknowledge and stay)
  Hangup       session over; KV pages are released

Gateway -> client:
  AudioChunk     one playable fragment (one decode token's worth of
                 speech); the client's playback clock consumes these
  TurnDone       the turn finished (or was barge-in aborted) server-side
  SessionClosed  gateway confirmed the hangup

Events carry the *session-local* wall-clock timestamp ``t`` stamped by
whoever created them; the gateway re-stamps arrival against its own
scaled clock, so clients cannot skew serving-side metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SessionEvent:
    session_id: str
    t: float = 0.0                  # sender-side scaled-clock timestamp


# --------------------------------------------------- client -> gateway
@dataclass
class UserAudio(SessionEvent):
    dur_s: float = 0.0


@dataclass
class SpeechStart(SessionEvent):
    expected_dur_s: Optional[float] = None


@dataclass
class SpeechEnd(SessionEvent):
    pass


@dataclass
class TurnRequest(SessionEvent):
    prompt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    max_new_tokens: int = 0
    # full duplex: > 0 arms a hard per-frame output deadline of this
    # many (serving-clock) seconds per token
    frame_period_s: float = 0.0
    # this request resumes a tool-call pause (telemetry: its reload
    # split is the resume-without-reprefill cost)
    tool_resume: bool = False


@dataclass
class BargeIn(SessionEvent):
    expected_dur_s: Optional[float] = None


@dataclass
class ToolCallStart(SessionEvent):
    expected_latency_s: float = 0.0


@dataclass
class ToolCallResult(SessionEvent):
    resume_gap_s: float = 0.0


@dataclass
class HandoffRequest(SessionEvent):
    target: int = 0                 # requested model config / replica


@dataclass
class Hangup(SessionEvent):
    pass


# --------------------------------------------------- gateway -> client
@dataclass
class AudioChunk(SessionEvent):
    turn_index: int = 0
    dur_s: float = 0.0
    token: int = -1


@dataclass
class TurnDone(SessionEvent):
    turn_index: int = 0
    aborted: bool = False
    generated: int = 0


@dataclass
class SessionClosed(SessionEvent):
    pass
