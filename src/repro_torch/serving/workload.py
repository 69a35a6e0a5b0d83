"""Workload generators — the paper's three data sources + arrival processes.

- sharegpt: single-turn conversational prompts, wide prompt/response
  spread (ShareGPT-Chinese-English-90K-like length distributions).
- interactive: multi-turn voice sessions with think-time gaps and growing
  context (retained interaction traces of the paper).
- mixed: interactive sessions + video events with large prefill
  (StreamingBench-like media turns).
- duplex: full-duplex periodic-frame sessions (Moshi/MiniCPM-o-like) —
  the turn request fires the instant speech starts and every output
  token carries a hard per-frame deadline (``frame_period_tokens``
  output-token durations per frame); no idle speech window exists.
- toolcall: agentic sessions whose turns may end in a tool call — the
  session idles with hot KV for ``tool_latency_s`` while the external
  tool runs, then resumes without a new utterance.
- handoff: multi-turn sessions that request a transfer to a different
  model config/replica between turns (rides the fleet MIGRATE path).

Arrivals: closed-loop concurrency bound c (the paper's frontier sweeps),
open-loop Poisson, and BurstGPT-like bursty arrivals (Gamma-modulated
rate spikes). Barge-in: per-request Bernoulli(p_bi), cut anchored at TTFP
plus a draw from the output-audio-duration distribution (§7.1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.session import Session, Turn

# gap between a ToolCallResult and the resume TurnRequest — part of the
# trace's interpretation, so both the live client and the replay twin
# must read the same constant (the preload window a resume hides in)
TOOL_RESUME_GAP_S = 0.6


@dataclass
class WorkloadConfig:
    kind: str = "sharegpt"           # sharegpt | interactive | mixed |
    #                                  duplex | toolcall | handoff
    num_sessions: int = 32
    p_barge_in: float = 0.0
    seed: int = 0
    # closed loop
    concurrency: Optional[int] = None
    # open loop
    arrival: str = "poisson"         # poisson | burstgpt
    rate_rps: float = 2.0
    burst_factor: float = 4.0        # peak/mean rate for burstgpt
    burst_period_s: float = 20.0
    audio_per_token_s: float = 0.08
    # shared-system-prompt families: sessions are assigned round-robin
    # to K families; sessions in the same family open their first turn
    # with an identical ``family_prefix_len``-token seeded prefix
    # (drawn by ``family_prefix``), so the prefix cache can attach
    # later arrivals to the first session's committed pages. 0 = off.
    prompt_families: int = 0
    family_prefix_len: int = 0


def _lognormal(rng, mean, sigma, lo, hi):
    v = rng.lognormal(math.log(mean), sigma)
    return float(min(max(v, lo), hi))


def _make_turns(rng, cfg: WorkloadConfig, kind: str) -> List[Turn]:
    turns = []
    if kind == "sharegpt":
        n_turns = 1
    elif kind == "interactive":
        n_turns = int(rng.integers(3, 8))
    elif kind == "duplex":
        n_turns = int(rng.integers(1, 4))
    elif kind == "toolcall":
        n_turns = int(rng.integers(3, 6))
    elif kind == "handoff":
        n_turns = int(rng.integers(2, 5))
    else:  # mixed: interactive with a chance of a video-heavy turn
        n_turns = int(rng.integers(2, 6))
    for i in range(n_turns):
        frame_period = 0.0
        tool_call, tool_latency = False, 0.0
        handoff, handoff_target = False, 0
        if kind == "sharegpt":
            prompt = int(_lognormal(rng, 600, 0.8, 40, 6000))
            resp_audio_s = _lognormal(rng, 22, 0.7, 3, 90)
        elif kind == "interactive":
            prompt = int(_lognormal(rng, 120, 0.6, 20, 1200))
            resp_audio_s = _lognormal(rng, 12, 0.6, 2, 60)
        elif kind == "duplex":
            # full duplex: the request fires at speech start, frames tick
            # from the first output token — short prompts, no barge-in
            # (the user never yields the channel in the first place)
            prompt = int(_lognormal(rng, 40, 0.4, 8, 200))
            resp_audio_s = _lognormal(rng, 8, 0.5, 2, 30)
            frame_period = float(rng.uniform(2.0, 4.0))
        elif kind == "toolcall":
            prompt = int(_lognormal(rng, 120, 0.6, 20, 1200))
            resp_audio_s = _lognormal(rng, 10, 0.6, 2, 50)
            if i + 1 < n_turns:
                tool_call = rng.random() < 0.6
                tool_latency = _lognormal(rng, 2.5, 0.4, 0.8, 8.0)
                if not tool_call:
                    tool_latency = 0.0
        elif kind == "handoff":
            prompt = int(_lognormal(rng, 120, 0.6, 20, 1200))
            resp_audio_s = _lognormal(rng, 10, 0.6, 2, 50)
            if i >= 1:
                handoff = rng.random() < 0.5
                handoff_target = int(rng.integers(0, 8))
                if not handoff:
                    handoff_target = 0
        else:
            video = rng.random() < 0.35
            prompt = int(_lognormal(rng, 4000 if video else 150, 0.5,
                                    30, 10000))
            resp_audio_s = _lognormal(rng, 15, 0.6, 2, 70)
        resp_tokens = max(8, int(resp_audio_s / cfg.audio_per_token_s))
        barge = (rng.random() < cfg.p_barge_in) and kind != "duplex"
        cut = float(rng.uniform(0.15, 0.75)) * resp_audio_s if barge else 0.0
        speech_dur = _lognormal(rng, 2.5, 0.5, 0.6, 8.0)
        turns.append(Turn(index=i, speech_start=0.0, speech_end=speech_dur,
                          prompt_len=prompt, response_tokens=resp_tokens,
                          barge_in=barge, barge_cut_s=cut,
                          frame_period_tokens=frame_period,
                          tool_call=tool_call, tool_latency_s=tool_latency,
                          handoff=handoff, handoff_target=handoff_target))
    return turns


def _burst_wave(cfg: WorkloadConfig):
    """The burstgpt square wave as (duty, peak_rate, off_rate), derived
    so the time-averaged rate is exactly ``rate_rps`` (burst_factor is
    the documented peak/mean ratio). The nominal burst duty is 0.3 of
    the period; for burst_factor > 1/0.3 that would need a negative
    off-phase rate, so the duty shrinks to 1/burst_factor and the off
    phase goes silent instead."""
    bf = max(1.0, cfg.burst_factor)
    duty = min(0.3, 1.0 / bf)
    peak = cfg.rate_rps * bf
    off = cfg.rate_rps * max(0.0, 1.0 - duty * bf) / (1.0 - duty) \
        if duty < 1.0 else 0.0
    return duty, peak, off


def _next_burst_arrival(rng, cfg: WorkloadConfig, t: float) -> float:
    """Next arrival of the square-wave-modulated Poisson process after
    ``t``: draw a unit-mean exponential hazard target and integrate the
    piecewise-constant rate forward until it is met. Exact for any
    duty/peak/off triple, including a silent off phase."""
    duty, peak, off = _burst_wave(cfg)
    period = cfg.burst_period_s
    need = rng.exponential(1.0)
    while need > 1e-12:
        start = t - (t % period)
        in_burst = (t - start) < duty * period
        rate = peak if in_burst else off
        seg_end = start + (duty * period if in_burst else period)
        if rate <= 0.0:
            t = seg_end
            continue
        if need <= (seg_end - t) * rate:
            return t + need / rate
        need -= (seg_end - t) * rate
        t = seg_end
    return t


def _arrival_times(rng, cfg: WorkloadConfig) -> List[float]:
    if cfg.concurrency is not None:
        # closed loop: session k>=c starts when an earlier one finishes;
        # the simulator handles gating, we just mark the first c at t=0.
        return [0.0] * cfg.num_sessions
    times, t = [], 0.0
    for i in range(cfg.num_sessions):
        if cfg.arrival == "poisson":
            t += rng.exponential(1.0 / cfg.rate_rps)
        else:  # burstgpt-like: mean-conserving square-wave modulation
            t = _next_burst_arrival(rng, cfg, t)
        times.append(t)
    return times


def generate(cfg: WorkloadConfig) -> List[Session]:
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(rng, cfg)
    sessions = []
    for i, t0 in enumerate(arrivals):
        turns = _make_turns(rng, cfg, cfg.kind)
        think = _lognormal(rng, 2.0, 0.5, 0.5, 8.0)
        family = i % cfg.prompt_families if cfg.prompt_families > 0 else -1
        sessions.append(Session(
            session_id=f"s{i:04d}", turns=turns, arrival_time=t0,
            think_time_s=think, family=family))
    return sessions


def family_prefix(cfg: WorkloadConfig, family: int, vocab: int,
                  seed: int) -> np.ndarray:
    """The shared system-prompt tokens for one family: a seeded draw
    keyed on (seed, family) only, so every session in the family — and
    every engine/gateway replaying the same workload — prepends the
    exact same tokens to its first-turn prompt."""
    rng = np.random.default_rng([seed, 1_000_003 + family])
    return rng.integers(0, vocab,
                        size=cfg.family_prefix_len).astype(np.int32)
