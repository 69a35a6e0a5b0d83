"""Session / turn / request state shared by the interaction plane and the
stage engines."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"          # arrived, not yet admitted
    RUNNING = "running"          # in the engine's running set
    PREEMPTED = "preempted"      # admitted before, currently descheduled
    FINISHED = "finished"
    ABORTED = "aborted"          # barge-in


class Phase(enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"


@dataclass
class Request:
    """One turn's work at one stage."""
    session_id: str
    stage: str
    turn_index: int
    arrival_time: float
    prompt_len: int                     # new tokens to prefill this turn
    context_len: int = 0                # cached history tokens (prior turns)
    max_new_tokens: int = 0             # sim oracle; engines don't read it
    req_id: int = field(default_factory=lambda: next(_req_counter))
    state: RequestState = RequestState.WAITING
    phase: Phase = Phase.PREFILL
    prefilled: int = 0                  # prompt tokens processed so far
    generated: int = 0                  # tokens decoded so far
    first_output_time: Optional[float] = None
    finish_time: Optional[float] = None
    # audio accounting (talker-stage requests)
    audio_per_token_s: float = 0.0      # seconds of audio per output token
    # bookkeeping for scheduling
    last_scheduled: float = -1.0
    reload_stall_s: float = 0.0         # on-path KV reload charged to TTFP
    reload_off_path_s: float = 0.0      # reload seconds hidden off-path
    prefix_hit_tokens: int = 0          # prompt tokens served from the
    #                                     shared prefix cache (skip-ahead)
    slot_bound: bool = True             # already holds a batch row; False
    #                                     for queued turns that still need
    #                                     a free slot to bind

    @property
    def total_context(self) -> int:
        return self.context_len + self.prefilled + self.generated

    @property
    def done_prefill(self) -> bool:
        return self.prefilled >= self.prompt_len

    def is_live(self) -> bool:
        return self.state in (RequestState.WAITING, RequestState.RUNNING,
                              RequestState.PREEMPTED)


@dataclass
class Turn:
    index: int
    speech_start: float          # user starts speaking (VAD trigger)
    speech_end: float            # utterance complete
    prompt_len: int
    response_tokens: int         # oracle: talker tokens of the reply
    barge_in: bool = False
    barge_cut_s: float = 0.0     # played-audio seconds at which user barges
    # full-duplex: > 0 marks a periodic-frame turn whose per-frame
    # deadline is this many output-token durations (dimensionless so the
    # serving side can scale by its own audio_per_token_s)
    frame_period_tokens: float = 0.0
    # agentic: the turn ends in a tool call — the session idles with hot
    # KV for ~tool_latency_s, then resumes without a new utterance
    tool_call: bool = False
    tool_latency_s: float = 0.0
    # agent handoff: before this turn's speech, the client requests the
    # session move to the model config / replica ``handoff_target``
    handoff: bool = False
    handoff_target: int = 0


@dataclass
class Session:
    session_id: str
    turns: list
    arrival_time: float
    think_time_s: float = 2.0    # gap between playback end and next speech
    current_turn: int = 0
    # cumulative context tokens cached at the LLM stage after each turn
    context_tokens: int = 0
    kv_bytes_per_token: float = 0.0
    # shared-system-prompt family (-1: none): sessions in the same
    # family open with an identical seeded prefix, so seeded traces
    # exercise cross-session prefix sharing deterministically
    family: int = -1
