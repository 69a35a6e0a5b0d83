"""The benchmark's own spans and counters on the system under test.

Nothing here edits the program. The probe sets one wrapper on the
engine instance, around its public ``run_round``, as ``chip_smoke.py``
does with its ``timed_round``, and while the profiler runs one on the
moe module's ``moe_apply``. It reads the engine's public state before
and after each round (its slots, each session's ``kv_len`` and fed
``token_ids``) and records

- every round: host start and end of ``run_round``, the pool pages in
  use as it began, and its rows (slot, session, first position, tokens
  fed, prefill or decode) with the token each row served;
- that each row fed what the benchmark says it should: a prefill row
  the next tokens of the prompt its client sent, a decode row the token
  its session was last served (``fed_mismatch`` counts rows that did
  not);
- during the profiled slice, the host span of each moe call and its
  routing (for its roofline).

Its work in a round is a few dictionary reads a row and the compare of
at most a prefill chunk of tokens, after ``run_round`` has returned.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


# a row is a plain tuple (slot, sid, first position, tokens fed, prefill,
# token served or None), which the garbage collector stops tracking, so
# the run's records do not lengthen the program's collections
SLOT, SID, START, TOKENS, PREFILL, SERVED = range(6)


@dataclass
class Round:
    t0: float
    t1: float = 0.0
    rows: tuple = ()
    traced: bool = False
    moe: tuple = ()                  # host spans of moe calls (traced)
    pages: int = 0                   # pool pages in use as the round began


class Probe:
    def __init__(self, engine, population=None):
        self.eng = engine
        self.pop = population
        self.rounds: List[Round] = []
        self.last_served: Dict[str, int] = {}
        self.fed_mismatch = 0
        self.fed_mismatch_first: Optional[str] = None
        self.tracing = False
        self.moe_calls: List[Tuple[object, object]] = []
        self.on_round = None         # called after each round (tracing)
        self._moe_spans: Optional[list] = None
        self.cost_s = 0.0            # the probe's own host time in rounds
        self._run = engine.run_round
        engine.run_round = self._run_round

    def _run_round(self, chunks):
        t = time.perf_counter()
        eng = self.eng
        pool = eng.pool
        before = []
        for slot in chunks:
            s = eng.slot_state.get(slot)
            if s is not None:
                req = s.request
                before.append((slot, s.session_id,
                               eng.sessions[s.session_id].kv_len,
                               req.phase.value == "prefill", req.prefilled))
        moe: list = []
        self._moe_spans = moe
        r = Round(time.perf_counter(), traced=self.tracing,
                  pages=pool.num_pages - pool.free_pages)
        self.cost_s += r.t0 - t
        events = self._run(chunks)
        r.t1 = time.perf_counter()
        self._moe_spans = None
        rows = []
        for slot, sid, kv0, prefill, offset in before:
            sess = eng.sessions.get(sid)
            if sess is None or sess.kv_len == kv0:
                continue                  # held this round
            toks = np.array(sess.token_ids[kv0:sess.kv_len], np.int32)
            self._check_feed(sid, toks, prefill, offset)
            served = None
            for kind, val in events.get(slot, ()):
                if kind == "token":
                    served = int(val)
                    self.last_served[sid] = served
            rows.append((slot, sid, kv0, toks, prefill, served))
        r.rows, r.moe = tuple(rows), tuple(moe)
        self.rounds.append(r)
        self.cost_s += time.perf_counter() - r.t1
        if self.on_round is not None:
            self.on_round(r)
        return events

    def _check_feed(self, sid, toks, prefill, offset) -> None:
        if prefill:
            turn = self.pop.latest.get(sid) if self.pop else None
            want = None if turn is None else \
                turn.prompt[offset:offset + len(toks)]
        else:
            last = self.last_served.get(sid)
            want = None if last is None else np.array([last], np.int32)
        if want is None or not np.array_equal(want, toks):
            self.fed_mismatch += 1
            if self.fed_mismatch_first is None:
                self.fed_mismatch_first = (
                    f"{sid} {'prefill' if prefill else 'decode'} row fed "
                    f"{toks[:8].tolist()}, expected "
                    f"{None if want is None else want[:8].tolist()}")

    # ----------------------------------------------------------- moe
    def wrap_moe(self, moe_mod, cfg) -> None:
        """While tracing: each moe call's host span, and its routing
        kept on the device (computed after the span, as the port's
        ``route`` computes it) for the moe roofline."""
        orig = moe_mod.moe_apply
        self._moe = (moe_mod, orig)
        top_k = cfg.moe.top_k

        def call(params, x, cfg_, mesh=None, valid=None, expert_tp=False):
            t0 = time.perf_counter()
            out = orig(params, x, cfg_, mesh=mesh, valid=valid,
                       expert_tp=expert_tp)
            if self.tracing and self._moe_spans is not None:
                self._moe_spans.append((t0, time.perf_counter()))
                x2 = x.reshape(-1, x.shape[-1])
                logits = (x2.double() @ params["router"].double()).float()
                sel = logits.softmax(-1).sort(
                    dim=-1, descending=True, stable=True).indices[:, :top_k]
                v = valid.reshape(-1) if valid is not None else None
                self.moe_calls.append((sel, v))
            return out
        moe_mod.moe_apply = call

    def unwrap_moe(self) -> None:
        if getattr(self, "_moe", None):
            mod, orig = self._moe
            mod.moe_apply = orig
            self._moe = None

    def restore(self) -> None:
        self.eng.run_round = self._run
        self.unwrap_moe()
