"""Traffic: one general generator of voice conversations, read from a
mix file (``livebench/traffic/<mix>.json``), and the clients that play
them against the gateway.

Frozen copies, kept here so that a change to the program cannot move
the yardstick:

- the turn shapes are ``_make_turns``'s (its ``interactive`` branch)
  of ``src/repro_torch/serving/workload.py`` at commit 197c0ec, with
  every constant moved into the mix file;
- the session driver is ``_drive_session`` of
  ``src/repro_torch/serving/gateway/client.py`` at the same commit,
  rewritten to keep every time on the host's monotonic clock (never the
  gateway's clock, which adds modelled reload time), to record what the
  client received, and to play a closed population: each of the mix's
  ``conversations`` speaks, waits, listens, thinks and speaks again, and
  one that hangs up is replaced at once by a fresh conversation.

The clients talk to the gateway only through the port's event types
(``repro_torch.serving.gateway.events``), which are the system's
protocol, sent and received through the session handle's ``send`` and
``recv``. A barge-in is the client's own timer, a task that sends
``BargeIn`` when the listener has heard the turn's cut.
"""
from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


# ----------------------------------------------------------------- shapes
@dataclass
class TurnShape:
    prompt_len: int
    reply_tokens: int
    speech_s: float
    barge: bool = False
    barge_cut_s: float = 0.0        # seconds of reply audio heard


@dataclass
class ConversationShape:
    turns: List[TurnShape]
    think_s: float


def _lognormal(rng, spec) -> float:
    v = rng.lognormal(math.log(spec["median"]), spec["sigma"])
    return float(min(max(v, spec["min"]), spec["max"]))


def make_conversation(rng, mix: dict) -> ConversationShape:
    """One conversation's shape, drawn in ``workload.py``'s order."""
    g = mix["generator"]
    apt = mix["audio_per_token_s"]
    lo, hi = g["turns"]
    n_turns = int(rng.integers(lo, hi + 1))
    turns = []
    for _ in range(n_turns):
        prompt = int(_lognormal(rng, g["prompt_tokens"]))
        reply_s = _lognormal(rng, g["reply_audio_s"])
        reply = max(g.get("min_reply_tokens", 8), int(reply_s / apt))
        barge = bool(rng.random() < g["p_barge_in"])
        cut = float(rng.uniform(*g["barge_cut_frac"])) * reply_s \
            if barge else 0.0
        speech = _lognormal(rng, g["speech_s"])
        turns.append(TurnShape(prompt, reply, speech, barge, cut))
    return ConversationShape(turns, _lognormal(rng, g["think_s"]))


# ----------------------------------------------------------------- records
@dataclass
class TurnLog:
    """What one client saw of one turn, on the host's monotonic clock."""
    conv: int
    session_id: str
    turn: int
    due: float                      # when the turn's request was due
    prompt: np.ndarray
    max_new: int
    apt: float                      # seconds of audio a token plays
    first: Optional[float] = None   # first AudioChunk received
    recv: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done: Optional[float] = None    # TurnDone received
    aborted: bool = False
    barge_at: Optional[float] = None


class Population:
    """The closed population of one run: ``mix['conversations']`` (n)
    clients, each a chain of conversations.

    Every run plays the same conversations; the seed only arranges
    them and draws their token ids. Conversation shape ``i`` is drawn
    from ``(mix['shape_seed'], i)``; the k-th conversation of every
    client comes from shapes ``[n k, n k + n)``, dealt to the clients
    in an order drawn from ``(seed, k)``, and its tokens from ``(seed,
    client, k)``. So a run's work does not depend on its seed (a seed
    that drew other lengths moved the TTFP tail by more than the
    host's noise), nor on how the event loop interleaves the clients.
    """

    def __init__(self, gateway, mix: dict, vocab: int, seed: int,
                 max_context: int):
        from repro_torch.serving.gateway import events as ev
        self.ev = ev
        self.gw = gateway
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.max_context = max_context
        self.n = int(mix["conversations"])
        self.apt = float(mix["audio_per_token_s"])
        self.turns: List[TurnLog] = []
        self.latest: Dict[str, TurnLog] = {}   # each session's last turn
        self.first_sent: Dict[int, float] = {}
        self.started = 0                # conversations begun
        self.late_s = 0.0               # worst lateness of a client wake-up
        self._shapes: Dict[int, ConversationShape] = {}

    def shape(self, c: int, k: int) -> ConversationShape:
        """The k-th conversation of client ``c``."""
        deal = np.random.default_rng([self.seed, 3, k]).permutation(self.n)
        i = self.n * k + int(deal[c])
        if i not in self._shapes:
            rng = np.random.default_rng([int(self.mix["shape_seed"]), i])
            self._shapes[i] = make_conversation(rng, self.mix)
        return self._shapes[i]

    # ----------------------------------------------------------- timing
    async def _until(self, t: float) -> None:
        """Sleep until host time ``t``; records how late the wake-up ran
        (a round blocks the event loop)."""
        dt = t - time.perf_counter()
        if dt > 0:
            await asyncio.sleep(dt)
        self.late_s = max(self.late_s, time.perf_counter() - t)

    # ----------------------------------------------------------- clients
    async def run(self) -> None:
        t0 = time.perf_counter()
        ramp = float(self.mix["ramp_s"])
        tasks = [asyncio.create_task(self._client(c, t0 + ramp * c
                                                  / self.n))
                 for c in range(self.n)]
        try:
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _client(self, c: int, start: float) -> None:
        k = 0
        t_speak = start
        while True:
            rng = np.random.default_rng([self.seed, c, k])
            shape = self.shape(c, k)
            self.started += 1
            t_speak = await self._conversation(c, k, shape, rng, t_speak)
            k += 1

    async def _conversation(self, c: int, k: int, shape, rng,
                            t_speak: float) -> float:
        """Play one conversation from ``t_speak`` (when its first
        utterance starts); returns when the replacement may start."""
        ev = self.ev
        sid = f"c{c:03d}k{k:03d}"
        handle = self.gw.connect(sid)
        used = 0                          # context the engine may hold
        for ti, turn in enumerate(shape.turns):
            prompt = rng.integers(0, self.vocab,
                                  size=max(1, turn.prompt_len)) \
                .astype(np.int32)
            n_tok = max(2, turn.reply_tokens)
            if used + len(prompt) + n_tok > self.max_context:
                break                     # the clamp pages_per_seq forces
            used += len(prompt) + n_tok
            await self._until(t_speak)
            await handle.send(ev.SpeechStart(
                sid, expected_dur_s=turn.speech_s))
            await handle.send(ev.UserAudio(sid, dur_s=turn.speech_s))
            due = t_speak + turn.speech_s
            await self._until(due)
            await handle.send(ev.SpeechEnd(sid))
            await handle.send(ev.TurnRequest(sid, prompt=prompt,
                                             max_new_tokens=n_tok))
            self.first_sent.setdefault(c, due)
            log = TurnLog(c, sid, ti, due, prompt, n_tok, self.apt)
            self.turns.append(log)
            self.latest[sid] = log
            cut_s = None
            if turn.barge:
                frac = turn.barge_cut_s / max(
                    1e-9, turn.reply_tokens * self.apt)
                cut_s = max(self.apt, min(frac, 0.9) * n_tok * self.apt)
            alarm = None
            play_end = None
            try:
                while True:
                    msg = await handle.recv()
                    now = time.perf_counter()
                    if isinstance(msg, ev.AudioChunk):
                        if log.first is None:
                            log.first = now
                            if cut_s is not None:
                                alarm = asyncio.create_task(self._barge(
                                    handle, sid, log, now + cut_s,
                                    turn.speech_s))
                        log.recv.append(now)
                        log.tokens.append(int(msg.token))
                        play_end = max(play_end or now, now) + msg.dur_s
                    elif isinstance(msg, ev.TurnDone):
                        log.done = now
                        log.aborted = bool(msg.aborted)
                        break
                if alarm is not None:
                    # a reply that ended before the cut is still
                    # playing: the listener barges in when the cut comes
                    await alarm
            finally:
                if alarm is not None:
                    alarm.cancel()
            last = ti == len(shape.turns) - 1
            if log.barge_at is not None:
                t_speak = log.barge_at    # the next utterance starts now
            else:
                now = time.perf_counter()
                t_speak = max(play_end or now, now) \
                    + (0.0 if last else shape.think_s)
        await self._until(t_speak)        # listen to the end, then hang up
        await handle.send(ev.Hangup(sid))
        while not isinstance(await handle.recv(), ev.SessionClosed):
            pass
        return time.perf_counter()

    async def _barge(self, handle, sid: str, log: TurnLog, at: float,
                     speech_s: float) -> None:
        """The listener's barge-in at host time ``at``. The gateway ends
        a turn still generating with ``TurnDone(aborted=True)``, which
        the client's read loop takes; a finished turn is cut in its
        playback."""
        await self._until(at)
        log.barge_at = time.perf_counter()
        await handle.send(self.ev.BargeIn(sid, expected_dur_s=speech_s))
