"""How ``correct`` is decided.

After the window has closed and the program's state is freed, a sample
of conversations, drawn from the seed, is run through the plain
reference (``livebench/reference/model.py``) over every token each was
fed, from position 0; the conversation served the most tokens is always
in it. At every position where the program served a token, the gap by
which that token's reference logit lies below the reference's best is
read. The cell's limits file (``livebench/limits/<cell>.json``) names
which of the gaps' statistics are compared:

- ``gap_max``, the widest;
- ``gap_q50``, the median;
- ``gap_turn_q50_max``, the largest of the sampled turns' medians, over
  the turns served at least ``TURN_MIN_TOKENS`` tokens;
- ``gap_turn_far_max``, the largest share, over the same turns, of a
  turn's served tokens whose gap passes ``FAR_GAP`` logits. A turn
  holds one slot of the batch from its first token to its last, so a
  fault confined to a few rows moves whole turns far, while the routing
  near-ties that bf16 rounding flips in a moe model move scattered
  tokens, and by less (PERF.md). A turn's median swings with the few
  tokens of a short turn; this share does not.

Beside them, counts that must be 0:

- ``fed_mismatch``: rows that fed anything but the next prompt tokens
  their client sent or the token their session was last served;
- ``position_gaps``: rows whose first position is not where the
  session's fed stream ended (KV written twice, or skipped);
- ``delivered_mismatch``: sampled sessions whose client received other
  tokens than the program served, in other order.

The control (``--control 1``, never in a measured run): the same
reference with every matrix product in float8 e4m3, the precision below
the served bfloat16; at the same positions the token it puts first is
read under the float32 reference, and its gaps are printed.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

TURN_MIN_TOKENS = 16
FAR_GAP = 1.0

def streams_of(rounds) -> tuple:
    """Every session's fed token stream; its served positions as
    ``(position, token, round, slot)``; the round order of every token;
    each round's token count; and the count of rows that did not
    continue their stream."""
    streams: Dict[str, List[int]] = {}
    served: Dict[str, List[tuple]] = {}
    order: List[tuple] = []
    counts: List[int] = []
    gaps = 0
    for ri, r in enumerate(rounds):
        n = 0
        for slot, sid, start, toks, _, srv in sorted(r.rows):
            st = streams.setdefault(sid, [])
            if start != len(st):
                gaps += 1
            p0 = len(st)
            st.extend(int(t) for t in toks)
            order.extend((sid, p) for p in range(p0, len(st)))
            n += len(toks)
            if srv is not None:
                served.setdefault(sid, []).append(
                    (len(st) - 1, srv, ri, slot))
        if n:
            counts.append(n)
    return streams, served, order, counts, gaps


def sample(served, turns, t0, t1, seed: int, k: int) -> List[str]:
    """Up to ``k`` sessions with a turn due in the window that were
    served tokens: the one served most, the rest drawn from the seed."""
    live = sorted({t.session_id for t in turns if t0 <= t.due < t1}
                  & set(served))
    if not live:
        return []
    pick = [max(live, key=lambda s: (len(served[s]), s))]
    rest = [s for s in live if s not in pick]
    rng = np.random.default_rng([seed, 7])
    n = max(0, min(k - len(pick), len(rest)))
    pick += [rest[i] for i in sorted(rng.choice(len(rest), n,
                                                replace=False))]
    return pick


def delivered_mismatch(turns, served, sids) -> int:
    """Sampled sessions whose client received other tokens than the
    program served, or in other order (tokens still on their way when
    the run stopped are not counted)."""
    bad = 0
    for s in sids:
        got = [tok for t in turns if t.session_id == s for tok in t.tokens]
        want = [e[1] for e in served.get(s, [])]
        bad += got != want[:len(got)]
    return bad


def _quantiles(t: torch.Tensor) -> dict:
    q = torch.quantile(t.float(), torch.tensor([0.5, 0.75, 0.9],
                                               device=t.device))
    return {"q50": float(q[0]), "q75": float(q[1]), "q90": float(q[2]),
            "max": float(t.max())}


def turn_spans(entries) -> List[tuple]:
    """The turns: runs of a session's served positions, each one past
    the last, of at least ``TURN_MIN_TOKENS``, as ``(start, end)``."""
    spans, start = [], 0
    for i in range(1, len(entries) + 1):
        if i == len(entries) or entries[i][0] != entries[i - 1][0] + 1 \
                or entries[i][4] != entries[i - 1][4]:
            if i - start >= TURN_MIN_TOKENS:
                spans.append((start, i))
            start = i
    return spans


def turn_q50_max(gap: torch.Tensor, entries) -> float:
    """The largest median gap of a turn."""
    return max((float(torch.quantile(gap[a:b], 0.5))
                for a, b in turn_spans(entries)), default=0.0)


def turn_far_max(gap: torch.Tensor, entries) -> float:
    """The largest share of a turn's tokens whose gap passes
    ``FAR_GAP``."""
    return max((float((gap[a:b] > FAR_GAP).float().mean())
                for a, b in turn_spans(entries)), default=0.0)


def run(model: dict, W: dict, probe, turns, window, seed: int, *,
        k: int, control: bool = False, log=print,
        dump: Optional[str] = None) -> dict:
    """The comparison; returns the numbers compared (before limits) and,
    under ``detail``, what the limits were set from. ``dump`` names a
    file for every compared token's readings."""
    from livebench.reference import model as ref
    t_start = time.perf_counter()
    streams, served, order, counts, gaps = streams_of(probe.rounds)
    sids = sample(served, turns, window[0], window[1], seed, k)
    out = {"fed_mismatch": probe.fed_mismatch, "position_gaps": gaps,
           "delivered_mismatch": delivered_mismatch(turns, served, sids),
           "sampled_sessions": len(sids),
           "served_tokens": sum(len(served[s]) for s in sids)}
    if probe.fed_mismatch_first:
        log(f"[check] first fed mismatch: {probe.fed_mismatch_first}")
    if not sids:
        for name in ("gap_max", "gap_q50", "gap_turn_q50_max",
                     "gap_turn_far_max"):
            out[name] = math.inf
        return out
    dev = W["embed"].device
    moe = bool(model.get("moe"))
    use = list(streams) if moe else sids
    tok = {s: torch.tensor(streams[s], dtype=torch.int64, device=dev)
           for s in use}
    want = {s: torch.tensor([e[0] for e in served.get(s, [])]
                            if s in sids else [], dtype=torch.int64,
                            device=dev) for s in use}
    entries = [(*e, s) for s in sids for e in served[s]]
    srv = torch.tensor([e[1] for e in entries], dtype=torch.int64,
                       device=dev)
    rounds = (order, counts) if moe else None
    with torch.no_grad():
        res = ref.forward(model, W, tok, want, rounds=rounds)
        lg = torch.cat([res[s] for s in sids])
        best = lg.max(-1).values
        gap = best - lg.gather(1, srv[:, None])[:, 0]
        out["gap_max"] = float(gap.max())
        out["gap_q50"] = float(torch.quantile(gap, 0.5))
        out["gap_turn_q50_max"] = turn_q50_max(gap, entries)
        out["gap_turn_far_max"] = turn_far_max(gap, entries)
        detail = {"gap": _quantiles(gap),
                  "agree": float((gap == 0).float().mean())}
        cols = {"gap": gap}
        if control:
            res = ref.forward(model, W, tok, want, rounds=rounds,
                              quant="fp8")
            ctl = torch.cat([res[s] for s in sids])
            cgap = best - lg.gather(1, ctl.argmax(-1)[:, None])[:, 0]
            cols["control_gap"] = cgap
            detail["control_gap"] = _quantiles(cgap)
            detail["control_agree"] = float((cgap == 0).float().mean())
            detail["control_gap_turn_q50_max"] = turn_q50_max(cgap,
                                                              entries)
            detail["control_gap_turn_far_max"] = turn_far_max(cgap,
                                                              entries)
    out["detail"] = detail
    out["reference_s"] = time.perf_counter() - t_start
    if dump:
        rows = {"sid": [e[4] for e in entries],
                "pos": [e[0] for e in entries],
                "round": [e[2] for e in entries],
                "slot": [e[3] for e in entries]}
        rows.update({n: [float(x) for x in v.cpu()]
                     for n, v in cols.items()})
        with open(dump + ".tokens.json", "w") as f:
            json.dump(rows, f)
    return out
