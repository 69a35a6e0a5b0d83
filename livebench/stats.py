"""The end-to-end arithmetic: percentiles, rates and the good-turn rule.

The percentile is ``Metrics.percentile`` of
``src/repro_torch/serving/metrics.py`` at commit 197c0ec (nearest rank:
the ``ceil(p / 100 * n)``-th smallest), and a turn's continuity limit
is that file's ``TurnRecord.continuous`` (no gap over 0.100 s). A turn
that never got its first audio is an infinite time: it ranks above
every percentile, and no median of anything is taken over chunks or
rounds.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

TTFP_LIMIT_S = 2.0          # a turn is good only if its first audio came
GAP_LIMIT_S = 0.100         # within 2 s, with no playback gap over 100 ms


def percentile(values: Sequence[float], p: float) -> float:
    vals = sorted(values)
    if not vals:
        return float("nan")
    i = min(len(vals) - 1, int(math.ceil(p / 100 * len(vals))) - 1)
    return vals[max(0, i)]


def ttfp_s(turn) -> float:
    """Due to first packet, on the host clock; inf when none came."""
    return math.inf if turn.first is None else turn.first - turn.due


def max_gap_s(turn, until: float) -> float:
    """The longest stall of the turn's playback before ``until`` (the
    window's end, or the barge-in if earlier): audio plays back to back
    from the first packet, and a packet that arrives after the buffer
    ran dry opens a gap. A buffer still dry at ``until`` on a turn that
    had more to say is a gap too."""
    if turn.first is None:
        return 0.0
    end = until if turn.barge_at is None else min(until, turn.barge_at)
    play_end, worst = None, 0.0
    apt = turn.apt
    for t in turn.recv:
        if t > end:
            break
        if play_end is not None and t > play_end:
            worst = max(worst, t - play_end)
        play_end = max(play_end or t, t) + apt
    finished = turn.done is not None and turn.done <= end
    if play_end is not None and not finished and end > play_end \
            and len(turn.recv) < turn.max_new - 1:
        worst = max(worst, end - play_end)
    return worst


def good(turn, until: float) -> bool:
    return ttfp_s(turn) <= TTFP_LIMIT_S and max_gap_s(turn, until) \
        <= GAP_LIMIT_S


def heard_tokens(turn) -> int:
    """Tokens whose playback began before the barge-in (all of them
    when the turn was not cut)."""
    if turn.barge_at is None:
        return len(turn.recv)
    play_end, n = None, 0
    for t in turn.recv:
        start = t if play_end is None else max(play_end, t)
        if start >= turn.barge_at:
            break
        n += 1
        play_end = start + turn.apt
    return n


def window_turns(turns, t0: float, t1: float) -> List:
    """The turns whose request was due inside [t0, t1)."""
    return [t for t in turns if t0 <= t.due < t1]


def end_to_end(turns, t0: float, t1: float,
               end: Optional[float] = None) -> dict:
    """The end-to-end numbers of the window [t0, t1) (seconds on the
    host clock); ``end`` is the end of the drain (default ``t1``).
    Rates run over the whole window."""
    win = window_turns(turns, t0, t1)
    ttfps = [ttfp_s(t) for t in win]
    seen = max([v for v in ttfps if v != math.inf], default=0.0)
    end = t1 if end is None else end
    ttfps = [v if v != math.inf else max(seen, end - t.due)
             for v, t in zip(ttfps, win)]
    n_good = sum(good(t, t1) for t in win)
    return {
        "attempted": len(win),
        "failed": sum(1 for t in win if t.first is None),
        "ttfp_p50_ms": percentile(ttfps, 50) * 1e3,
        "ttfp_p90_ms": percentile(ttfps, 90) * 1e3,
        "good_turns_per_s": n_good / (t1 - t0),
        "good_share": n_good / len(win) if win else float("nan"),
    }

