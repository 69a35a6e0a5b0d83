"""In-process gateway clients (DESIGN.md §4).

``run_load`` replays ``serving/workload.py`` traces against a
``RealtimeGateway`` in scaled real time: per-session asyncio tasks speak
(SpeechStart → UserAudio → SpeechEnd), submit the encoded turn
(TurnRequest), consume AudioChunks into a client-side playback estimate,
barge in at the trace's cut point — anchored after the first audio
packet, like the simulator — think, and speak again. The same arrival
processes (poisson / burstgpt) and Bernoulli barge-in used for the
paper-scale simulations therefore drive the real paged data plane.

Trace lengths are clamped (``max_prompt`` / ``max_response`` /
``max_turns``) so laptop-scale engine contexts can serve the
distribution's shape without its tails.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.session import Session
from repro_torch.serving.gateway.events import (AudioChunk, BargeIn, Hangup,
                                                HandoffRequest, SessionClosed,
                                                SpeechEnd, SpeechStart,
                                                ToolCallResult, ToolCallStart,
                                                TurnDone, TurnRequest,
                                                UserAudio)
from repro_torch.serving.workload import (TOOL_RESUME_GAP_S, WorkloadConfig,
                                          family_prefix, generate)


@dataclass
class LoadGenConfig:
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    vocab: int = 331                 # token ids drawn uniform [0, vocab)
    max_prompt: int = 16             # clamp trace prompt lengths
    max_response: int = 12           # clamp trace response tokens
    max_turns: int = 2               # clamp turns per session
    audio_per_token_s: float = 0.08  # must match GatewayConfig
    speech_scale: float = 1.0        # shrink utterances for fast tests
    seed: int = 0


async def _drive_session(gateway, clock, s: Session,
                         cfg: LoadGenConfig, rng) -> None:
    handle = gateway.connect(s.session_id)
    sid = s.session_id
    await clock.sleep(max(0.0, s.arrival_time - clock.now()))
    turns = s.turns[:cfg.max_turns]
    fam = (family_prefix(cfg.workload, s.family, cfg.vocab, cfg.seed)
           if s.family >= 0 and cfg.workload.family_prefix_len > 0
           else None)
    tool_resume = False
    for ti, turn in enumerate(turns):
        duplex = turn.frame_period_tokens > 0.0
        prompt = rng.integers(0, cfg.vocab,
                              size=max(1, min(turn.prompt_len,
                                              cfg.max_prompt)))
        if fam is not None and ti == 0:
            # shared system prompt rides unclamped ahead of the draw —
            # the exact splice the replay twin performs
            prompt = np.concatenate([fam, prompt.astype(np.int32)])
        n_tokens = max(2, min(turn.response_tokens, cfg.max_response))
        speech_dur = max(0.05, (turn.speech_end - turn.speech_start)
                         * cfg.speech_scale)
        if turn.handoff:
            # requested while idle (between turns), before this turn's
            # utterance — the move hides in speech, like a migration
            await handle.send(HandoffRequest(
                sid, target=turn.handoff_target))
        if tool_resume:
            # tool-pause resume: the tool result IS the turn input —
            # no new utterance, no SpeechStart/End
            await handle.send(TurnRequest(sid, prompt=prompt,
                                          max_new_tokens=n_tokens,
                                          tool_resume=True))
        elif duplex:
            # full duplex: the request fires at speech onset; the user
            # keeps talking while the model answers, so no duration
            # estimate and no SpeechEnd gate the turn
            await handle.send(SpeechStart(sid))
            await handle.send(UserAudio(sid, dur_s=speech_dur))
            await handle.send(TurnRequest(
                sid, prompt=prompt, max_new_tokens=n_tokens,
                frame_period_s=(turn.frame_period_tokens
                                * cfg.audio_per_token_s)))
        else:
            await handle.send(SpeechStart(sid, expected_dur_s=speech_dur))
            await handle.send(UserAudio(sid, dur_s=speech_dur))
            await clock.sleep(speech_dur)
            await handle.send(SpeechEnd(sid))
            await handle.send(TurnRequest(sid, prompt=prompt,
                                          max_new_tokens=n_tokens))
        # barge cut re-anchored to the clamped reply length so short
        # test replies still get cut mid-playback
        cut_s: Optional[float] = None
        if turn.barge_in:
            frac = turn.barge_cut_s / max(
                1e-9, turn.response_tokens * cfg.audio_per_token_s)
            cut_s = max(cfg.audio_per_token_s,
                        min(frac, 0.9) * n_tokens * cfg.audio_per_token_s)
        play_end = clock.now()           # client-side playback estimate
        deadline = None                  # barge-in instant (post-TTFP)
        done = False                     # server closed the turn
        barged = False
        while True:
            timeout = None
            if deadline is not None and not barged:
                timeout = max(0.0, clock.real_s(deadline - clock.now()))
            try:
                if timeout is None:
                    ev = await handle.recv()
                else:
                    ev = await asyncio.wait_for(handle.recv(), timeout)
            except asyncio.TimeoutError:
                # the trace's barge point: interrupt playback. The next
                # utterance starts now, so its expected duration rides
                # along for the preloader's admission window.
                barged = True
                await handle.send(BargeIn(
                    sid, expected_dur_s=speech_dur))
                if done:
                    break                # server already closed the turn
                continue
            if isinstance(ev, AudioChunk):
                if deadline is None and cut_s is not None:
                    deadline = clock.now() + cut_s
                play_end = max(play_end, clock.now()) + ev.dur_s
            elif isinstance(ev, TurnDone):
                done = True
                if ev.aborted or barged or deadline is None:
                    break
                if clock.now() >= deadline:
                    # TurnDone raced past the barge deadline: the cut
                    # still happens (mid-playback barge on a completed
                    # turn), it just gets no abort ack
                    barged = True
                    await handle.send(BargeIn(
                        sid, expected_dur_s=speech_dur))
                    break
                # completed, but a barge is still scheduled mid-playback:
                # keep waiting for the deadline
        last = ti == len(turns) - 1
        if duplex and not barged:
            await handle.send(SpeechEnd(sid))   # utterance over with turn
        tool_resume = False
        if turn.tool_call and not barged and not last:
            # the reply ended in a tool invocation: idle with hot KV for
            # the tool's latency, then resume after a short result gap
            await handle.send(ToolCallStart(
                sid, expected_latency_s=turn.tool_latency_s))
            await clock.sleep(turn.tool_latency_s)
            await handle.send(ToolCallResult(
                sid, resume_gap_s=TOOL_RESUME_GAP_S))
            await clock.sleep(TOOL_RESUME_GAP_S)
            tool_resume = True
        elif not barged:
            # listen to the rest of the reply, think, then speak again
            drain = max(0.0, play_end - clock.now())
            await clock.sleep(drain + (0.0 if last else s.think_time_s))
    await handle.send(Hangup(sid))
    while True:                          # drain until the close ack
        ev = await handle.recv()
        if isinstance(ev, SessionClosed):
            return


async def run_load(gateway, cfg: LoadGenConfig) -> None:
    """Replay the workload against the gateway; returns when every
    session has hung up and been acknowledged."""
    sessions = generate(cfg.workload)
    # per-session streams: prompt token draws stay deterministic no
    # matter how the event loop interleaves the session tasks
    tasks = [asyncio.create_task(
        _drive_session(gateway, gateway.clock, s, cfg,
                       np.random.default_rng([cfg.seed, i])))
        for i, s in enumerate(sessions)]
    await asyncio.gather(*tasks)
